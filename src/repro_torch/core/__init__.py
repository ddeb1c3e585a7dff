from repro_torch.core.packing import (
    LANE_BITS,
    pack_bits,
    pack_conv_tile,
    packed_len,
    unpack_bits,
    unpack_conv_tile,
)
from repro_torch.core.policy import TBNPolicy, fp32_policy, tbn_policy
from repro_torch.core.tiling import (
    ConvTilePlan,
    TileSpec,
    compute_alpha,
    expand_alpha,
    plan_conv_tiling,
    plan_tiling,
    tile_vector,
    tiled_matmul_reference,
)
