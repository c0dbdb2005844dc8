"""Light-client serving gateway (the port's copy of `spectre_tpu/gateway/`):
cacheable HTTP read plane in front of the follower's UpdateStore
(content-addressed edge cache + update-range packs). See serving.py for
the route/semantics contract."""

from .cache import CACHE_MB_ENV, DEFAULT_CACHE_MB, GatewayCache
from .packs import (DEFAULT_PACK_PERIODS, PACK_FAULT_SITE, PACK_MAGIC,
                    PACK_PERIODS_ENV, PACK_SUFFIX, PACKS_JOURNAL_NAME,
                    PackBuilder, canonical_update_body, decode_pack,
                    encode_pack)
from .serving import (DEFAULT_HEAD_TTL_S, HEAD_TTL_ENV, SEALED_MAX_AGE,
                      Gateway, gateway_snapshot)

__all__ = [
    "CACHE_MB_ENV", "DEFAULT_CACHE_MB", "GatewayCache",
    "DEFAULT_PACK_PERIODS", "PACK_FAULT_SITE", "PACK_MAGIC",
    "PACK_PERIODS_ENV", "PACK_SUFFIX", "PACKS_JOURNAL_NAME",
    "PackBuilder", "canonical_update_body", "decode_pack", "encode_pack",
    "DEFAULT_HEAD_TTL_S", "HEAD_TTL_ENV", "SEALED_MAX_AGE",
    "Gateway", "gateway_snapshot",
]
