"""Beyond-paper: algebraic collapse of tile replication through ReLU MLPs
(port of ``repro/core/collapse.py``).

alpha scalars are L1 means, hence non-negative, so for any positive-
homogeneous activation phi (ReLU, leaky-ReLU, identity):

    phi(kron(alpha, u)) = kron(alpha, phi(u))

and a subsequent (dense, possibly tiled) layer W2 absorbs the replication
through its contraction:

    W2 @ kron(alpha, u) = (sum_i alpha_i * W2[:, i*r:(i+1)*r]) @ u

So a chain  x -> TiledDense(W1) -> relu -> Dense/TiledDense(W2) -> ...
never needs the p-replicated activations: each layer passes the *unique*
r-dim activation forward and the consumer pre-folds alpha into its own
weight columns once at load time. End-to-end this removes the p× FLOP and
activation-memory overhead that the paper's kernel only removes for weight
*storage*.

Only the last tiled layer before a non-homogeneous op (softmax head, norm,
GELU) must materialize the replication.
"""
from __future__ import annotations

import torch

from repro_torch.core.tiling import TileSpec


def fold_consumer_weight(w2: torch.Tensor, alpha: torch.Tensor,
                         producer_spec: TileSpec) -> torch.Tensor:
    """Pre-fold a consumer weight (n_out2, n_out1) across the producer's
    tiles: (n_out2, r), w2_folded = sum_i alpha_i * W2[:, blk_i], for
    alpha_mode "layer" (one scalar) and "tile"."""
    p = producer_spec.p
    r = producer_spec.rows_per_tile
    blocks = w2.reshape(w2.shape[0], p, r)
    alpha = alpha.to(w2.dtype)
    if producer_spec.alpha_mode == "layer":
        return alpha.reshape(()) * blocks.sum(dim=1)
    return torch.einsum("opr,p->or", blocks, alpha)


def collapsed_chain_reference(x: torch.Tensor, t1: torch.Tensor,
                              alpha1: torch.Tensor, spec1: TileSpec,
                              w2: torch.Tensor) -> torch.Tensor:
    """relu(x @ W1_hat^T) @ W2^T computed without replication."""
    n_in = spec1.n // spec1.shape[0]
    r = spec1.rows_per_tile
    u = torch.relu(torch.einsum("...k,rk->...r", x, t1.reshape(r, n_in).to(x.dtype)))
    w2f = fold_consumer_weight(w2, alpha1, spec1)         # (n_out2, r)
    return torch.einsum("...r,or->...o", u, w2f)
