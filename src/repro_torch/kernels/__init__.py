from repro_torch.kernels.ops import (
    FlatTileLayoutError,
    resolve_conv_padding,
    tbn_dense_train,
    tile_construct,
    tiled_conv_infer,
    tiled_dense_infer,
)
from repro_torch.kernels.tile_construct import (
    tile_construct_kernel,
    tile_construct_plain,
)
from repro_torch.kernels.tiled_conv import tiled_conv_plain, tiled_conv_unique
from repro_torch.kernels.tiled_matmul import tiled_matmul_plain, tiled_matmul_unique
from repro_torch.kernels.tiled_matvec import (
    MATVEC_MAX_M,
    tiled_matvec_plain,
    tiled_matvec_unique,
)
from repro_torch.kernels.tiled_xnor import (
    COMPUTE_PATHS,
    int8_matvec_packed,
    tiled_int8_matvec_unique,
    tiled_xnor_matvec_unique,
    xnor_matvec_words,
)
