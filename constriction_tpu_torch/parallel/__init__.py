"""Block-sharded containers and block legs over one card or a list of
devices.  JAX counterpart: ``constriction_tpu.parallel`` (its mesh helpers
``make_mesh`` / ``BLOCK_AXIS`` become the ``device`` argument, and its
ILANS v1 and ``jax_coder2`` legs are not ported)."""

from .container import (
    CODER_RANGE,
    CODER_RANS,
    MAGIC_S,
    build_block_checkpoints,
    decode,
    decode_block_from_checkpoint,
    encode,
    encode_host,
    pack_sharded,
    pack_sharded_v2,
    unpack_sharded,
    unpack_sharded_v2,
)
from .dryrun import dryrun
from .sharding import (
    prepare_blocks,
    shard_decode2_cuda,
    shard_decode64_cuda,
    shard_decode_exact_family_cuda,
    shard_decode_family_cuda,
    shard_decode_range64_cuda,
    shard_decode_range_cuda,
    shard_encode2_cuda,
    shard_tchain_decode_cuda,
)

__all__ = [
    "CODER_RANGE",
    "CODER_RANS",
    "MAGIC_S",
    "build_block_checkpoints",
    "decode",
    "decode_block_from_checkpoint",
    "dryrun",
    "encode",
    "encode_host",
    "pack_sharded",
    "pack_sharded_v2",
    "prepare_blocks",
    "shard_decode2_cuda",
    "shard_decode64_cuda",
    "shard_decode_exact_family_cuda",
    "shard_decode_family_cuda",
    "shard_decode_range64_cuda",
    "shard_decode_range_cuda",
    "shard_encode2_cuda",
    "shard_tchain_decode_cuda",
    "unpack_sharded",
    "unpack_sharded_v2",
]
