from repro_torch.kernels.ops import (
    FlatTileLayoutError,
    tiled_dense_infer,
)
from repro_torch.kernels.tiled_matmul import tiled_matmul_plain, tiled_matmul_unique
from repro_torch.kernels.tiled_matvec import (
    MATVEC_MAX_M,
    tiled_matvec_plain,
    tiled_matvec_unique,
)
