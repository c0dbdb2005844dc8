"""Load generator for the serving gateway (the port's copy of
`spectre_tpu/loadgen/`): Zipf-distributed simulated light-client
populations with client-side ETag caches. See drill.py."""

from .drill import (DEFAULT_MIX, DEFAULT_ZIPF_S, HttpTarget,
                    InProcessTarget, ZipfSampler, run_drill)

__all__ = ["DEFAULT_MIX", "DEFAULT_ZIPF_S", "HttpTarget",
           "InProcessTarget", "ZipfSampler", "run_drill"]
