from repro_torch.serve.detok import DetokenizeWorker, PieceCodec, decode_all
from repro_torch.serve.engine import (
    AdmissionQueueFull,
    BatchedEngine,
    Request,
    ServeConfig,
)
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.prefix import PrefixTrie
from repro_torch.serve.sampling import SamplingParams, sample_logits
from repro_torch.serve.server import EngineServer, ServerConfig, run_server
from repro_torch.serve.weights import (
    export_serving_params,
    serving_bytes,
    tile_serving_bytes,
)

__all__ = [
    "AdmissionQueueFull",
    "BatchedEngine",
    "DetokenizeWorker",
    "EngineServer",
    "KVPool",
    "PieceCodec",
    "PrefixTrie",
    "Request",
    "SamplingParams",
    "ServeConfig",
    "ServerConfig",
    "decode_all",
    "run_server",
    "sample_logits",
    "export_serving_params",
    "serving_bytes",
    "tile_serving_bytes",
]
