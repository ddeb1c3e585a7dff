from repro_torch.core.packing import LANE_BITS, pack_bits, packed_len, unpack_bits
from repro_torch.core.policy import TBNPolicy, fp32_policy, tbn_policy
from repro_torch.core.tiling import (
    TileSpec,
    compute_alpha,
    expand_alpha,
    plan_tiling,
    tile_vector,
    tiled_matmul_reference,
)
