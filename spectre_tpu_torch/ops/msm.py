"""Pippenger MSM over BN254 G1 on the device: signed digits, K1 bucket sums,
K2b weighted aggregation, and the window combine on the host.

The port of the reference's Pallas pipeline (`spectre_tpu/ops/msm.py` `msm`
with SPECTRE_MSM_IMPL=pallas, `_msm_pallas`), in its four modes
(SPECTRE_MSM_MODE, `msm_mode()`), which all give the same group element:

  vanilla     full 254-bit scalars recoded into digits in
              [-2^(c-1)+1, 2^(c-1)], nwin = ceil(255 / c) windows over the
              base, 2^(c-1) buckets a window, the windows combined on the
              host.
  glv         each scalar split k = k1 + k2 lambda (ops/glv.py, on the
              device), |k_i| < 2^126, over the expanded base [P ; phi(P)]
              (ops.ec.endo): half the windows over twice the points; the
              halves' signs ride in K1's per-point sign mask. The reference's
              Pallas route runs glv with signed digits, so here glv and
              glv+signed are one path.
  glv+signed  the same.
  fixed       for a fixed base (the SRS): a table T[w] = 2^(c w) [P ; phi(P)]
              per window, built once by c doublings a window through K2,
              normalised to Z = 1 and kept in a byte-budgeted LRU; K1's
              fixed-base form adds window
              w's digits over T[w], the bucket sums are merged across windows
              (a K2 tree) and weighted once (one K2b over one window), and no
              window combine is left. A table the budget (SPECTRE_MSM_TABLE_MB,
              default min(8 GiB, a quarter of host RAM)) cannot hold by
              itself degrades the call to glv+signed, visibly: COUNTERS
              ["msm_fixed_degraded"] and a line on stderr.
"""

from __future__ import annotations

import collections
import os
import sys

import torch

from ..fields import bn254
from . import ec, glv
from . import field_ops as F
from . import msm_kernels as MK

SCALAR_BITS = 254

MSM_MODES = ("vanilla", "glv", "glv+signed", "fixed")

# visible fallbacks (the reference's ServiceHealth counters); a service
# exports them
COUNTERS = {"msm_fixed_degraded": 0}

# VMEM the reference's Pallas bucket kernel may spend on resident buckets;
# it sizes the reference's window table, which the port keeps so both
# packages run the same window.
_PALLAS_BUCKET_VMEM_BUDGET = 8 << 20


def msm_mode() -> str:
    """The MSM mode from SPECTRE_MSM_MODE (default vanilla), read per call."""
    mode = os.environ.get("SPECTRE_MSM_MODE", "vanilla")
    if mode not in MSM_MODES:
        raise ValueError(f"SPECTRE_MSM_MODE={mode!r}: expected one of {MSM_MODES}")
    return mode


def window_override() -> int | None:
    """The window from SPECTRE_MSM_WINDOW (1..13; unset or empty: the
    tables below)."""
    v = os.environ.get("SPECTRE_MSM_WINDOW")
    if v is None or v == "":
        return None
    c = int(v)
    if not 1 <= c <= 13:
        raise ValueError(f"SPECTRE_MSM_WINDOW={v}: expected 1..13")
    return c


def default_window(n: int, signed: bool = False) -> int:
    """The reference's window table (`msm.default_window`) for n points
    (the expanded count under GLV); SPECTRE_MSM_WINDOW overrides it."""
    ov = window_override()
    if ov is not None:
        return ov
    if n >= 1 << 18:
        return 13
    if signed:
        return 11 if n >= 1 << 12 else 8 if n >= 1 << 7 else 5
    return 10 if n >= 1 << 12 else 7 if n >= 1 << 7 else 4


def default_window_fixed(n: int) -> int:
    return default_window(n, signed=True)


def num_windows(c: int, nbits: int = SCALAR_BITS) -> int:
    """ceil((nbits + 1) / c): room for the signed recode's final carry."""
    return (nbits + c) // c


def _pallas_bucket_bytes(c: int, nbits: int) -> int:
    return num_windows(c, nbits) * 48 * (1 << (c - 1)) * 4


def default_window_pallas(n: int, signed: bool = False) -> int:
    """Window of the reference's Pallas path (`msm.default_window_pallas`):
    the table's width for the size class, shrunk until the resident buckets
    fit the reference's VMEM budget (nbits 126 for the signed GLV paths,
    254 for vanilla); SPECTRE_MSM_WINDOW overrides it."""
    nbits = glv.glv_bits() if signed else SCALAR_BITS
    c = default_window(n, signed=signed)
    if window_override() is not None:
        return c
    while c > 1 and _pallas_bucket_bytes(c, nbits) > _PALLAS_BUCKET_VMEM_BUDGET:
        c -= 1
    return c


# ---------------------------------------------------------------------------
# digits
# ---------------------------------------------------------------------------

def window_digits(limbs: torch.Tensor, c: int, nwin: int) -> torch.Tensor:
    """Unsigned c-bit windows of scalars held as 16-bit limbs, limb-major
    [L, n] int64 -> [nwin, n] int64, lowest window first (c <= 32)."""
    nl = limbs.shape[0]
    zero = torch.zeros_like(limbs[0])
    out = []
    for w in range(nwin):
        k, s = divmod(w * c, 16)
        v = zero
        for j in range(3):
            if k + j < nl:
                v = v | (limbs[k + j] << (16 * j))
        out.append((v >> s) & ((1 << c) - 1))
    return torch.stack(out)


def signed_digits(limbs: torch.Tensor, c: int, nwin: int) -> torch.Tensor:
    """[L, n] 16-bit limbs -> [nwin, n] int32 signed digits in
    [-2^(c-1)+1, 2^(c-1)]: a digit above 2^(c-1) becomes d - 2^c with a
    carry of one into the next window (the reference's carry recode)."""
    half = 1 << (c - 1)
    raw = window_digits(limbs, c, nwin)
    carry = torch.zeros_like(raw[0])
    out = []
    for w in range(nwin):
        d = raw[w] + carry
        carry = (d > half).to(torch.int64)
        out.append(d - (carry << c))
    return torch.stack(out).to(torch.int32)


def signed_digit_stream(scalars: torch.Tensor, c: int, nwin: int) -> torch.Tensor:
    """[n, 4] standard-form scalars -> [nwin, n] int32 signed digits."""
    return signed_digits(F.split16(scalars), c, nwin)


# ---------------------------------------------------------------------------
# GLV
# ---------------------------------------------------------------------------

def expand_endo(points: torch.Tensor) -> torch.Tensor:
    """AoS32 [n, 24] -> [2n, 24]: [P ; phi(P)] (the reference's
    `_expand_endo`)."""
    return torch.cat([points, ec.endo(points)])


def glv_scalars(scalars: torch.Tensor):
    """[n, 4] standard-form scalars -> (magnitudes [8, 2n] int64 16-bit
    limbs, limb-major: k1 of every scalar, then k2; signs [1, 2n] int32),
    split on the scalars' device (the reference's `_glv_scalars_device`)."""
    mag, neg = glv.split_limbs(F.split16(scalars))
    return mag.reshape(glv.HALF_LIMBS, -1), neg.reshape(1, -1).to(torch.int32)


def glv_split(points: torch.Tensor, scalars: torch.Tensor, base_key=None):
    """The GLV modes' inputs (the reference's `glv_split`): ([P ; phi(P)]
    [2n, 24], magnitudes [8, 2n], signs [1, 2n]); the signs stay out of the
    points, K1 folds them into its per-point sign mask."""
    return (expanded_base(points, base_key), *glv_scalars(scalars))


# ---------------------------------------------------------------------------
# fixed-base tables: a byte-budgeted LRU on the device
# ---------------------------------------------------------------------------

class TableLRU:
    """Byte-budgeted LRU over derived device tables (the reference's
    `_TableLRU`): every entry can be rebuilt from a base the caller still
    holds, so eviction costs time, never correctness. An entry keyed by its
    base's storage address holds a reference to that base, so the address
    cannot be reused while the entry lives."""

    def __init__(self, budget_bytes: int, label: str = "msm fixed-base table",
                 budget_var: str = "SPECTRE_MSM_TABLE_MB"):
        self.budget = budget_bytes
        self.label = label
        self.budget_var = budget_var
        self._d = collections.OrderedDict()    # key -> (base ref, table, bytes)
        self._bytes = 0
        self.hits = self.builds = self.evictions = self.recomputes = 0
        self._evicted: set = set()

    def get(self, key):
        hit = self._d.get(key)
        if hit is None:
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return hit[1]

    def put(self, key, base, table, nbytes: int):
        """Keep `table` (nbytes by the budget's measure) unless it alone
        exceeds the budget; evict the oldest entries to make room."""
        self.builds += 1
        if key in self._evicted:
            self.recomputes += 1
            self._evicted.discard(key)
        if nbytes > self.budget:
            print(f"[lru] {self.label} ({nbytes >> 20} MB) exceeds {self.budget_var} "
                  f"budget ({self.budget >> 20} MB): uncached, every use rebuilds it",
                  file=sys.stderr, flush=True)
            return table
        while self._bytes + nbytes > self.budget and self._d:
            old_key, (_, _, old_bytes) = self._d.popitem(last=False)
            self._bytes -= old_bytes
            self.evictions += 1
            self._evicted.add(old_key)
        self._d[key] = (base, table, nbytes)
        self._bytes += nbytes
        return table

    def clear(self) -> None:
        self._d.clear()
        self._bytes = 0

    def keep_only(self, base_keys) -> int:
        """Drop every entry whose base is not named in base_keys; returns
        the bytes freed."""
        freed = 0
        for key in [k for k in self._d if k[0] not in base_keys]:
            freed += self._d.pop(key)[2]
        self._bytes -= freed
        return freed

    def stats(self) -> dict:
        return {"hits": self.hits, "builds": self.builds, "evictions": self.evictions,
                "recomputes": self.recomputes, "bytes": self._bytes,
                "budget_bytes": self.budget, "entries": len(self._d)}


def table_budget_bytes() -> int:
    """The reference's rule: SPECTRE_MSM_TABLE_MB if set, else min(8 GiB, a
    quarter of host RAM)."""
    mb = os.environ.get("SPECTRE_MSM_TABLE_MB")
    if mb is not None:
        return int(mb) << 20
    try:
        with open("/proc/meminfo") as f:
            total = int(f.readline().split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        return 8 << 30
    return min(8 << 30, int(total * 0.25))


TABLES = TableLRU(table_budget_bytes())
# expanded GLV bases [P ; phi(P)], keyed as the tables (few: one per SRS
# prefix in use)
_EXPANDED: dict = {}


def lru_stats() -> dict:
    return TABLES.stats()


def clear_tables() -> None:
    """Drop every cached table and expanded base (their device memory)."""
    TABLES.clear()
    _EXPANDED.clear()


def release_tables(base_keys) -> int:
    """Keep the tables and expanded bases of the bases named in base_keys
    (SRS digests) and drop the rest: a service holding several keys keeps
    only the caches of the circuit about to prove. Returns the table bytes
    freed."""
    for key in [k for k in _EXPANDED if k[0] not in base_keys]:
        del _EXPANDED[key]
    return TABLES.keep_only(base_keys)


def fixed_table_bytes(n: int, c: int, nbits: int) -> int:
    """The reference's byte count of an n-point GLV window table (its
    [nwin, 2n, 3, 16] uint32 layout): what the budget is held to, so both
    packages degrade at the same shapes."""
    return num_windows(c, nbits) * 2 * n * 3 * 16 * 4


def fixed_table_device_bytes(n: int, c: int, nbits: int) -> int:
    """The port's own bytes for the same table: AoS32, 96 bytes a point."""
    return num_windows(c, nbits) * 2 * n * 96


def _degrade_fixed(n: int, c: int, nbits: int) -> bool:
    """True (and counted) when one table would exceed the budget by itself:
    the call then runs glv+signed, the same group element without the
    table, instead of rebuilding an uncacheable table every MSM."""
    need = fixed_table_bytes(n, c, nbits)
    if need <= TABLES.budget:
        return False
    COUNTERS["msm_fixed_degraded"] += 1
    from ..observability.manifest import record_event
    record_event("msm_fixed_degraded", n=n, window=c, table_mb=need >> 20,
                 budget_mb=TABLES.budget >> 20)
    print(f"[msm] fixed-base table of {n} points at c={c} ({need >> 20} MB) exceeds "
          f"{TABLES.budget_var} budget ({TABLES.budget >> 20} MB): this MSM runs "
          f"glv+signed", file=sys.stderr, flush=True)
    return True


def build_window_table(points: torch.Tensor, c: int, nwin: int) -> torch.Tensor:
    """AoS32 [n, 24] -> [nwin, 2n, 24] with T[w] = 2^(c w) [P ; phi(P)],
    normalised: c doublings through K2 from one window to the next (the P
    half only), then every window's P half brought to Z = 1 by one batch
    inversion (`ec.normalize_mont`; a point at infinity keeps Z = 0), then
    the phi half of every window by one K3 (phi commutes with doubling and
    keeps Z). The fixed walk adds the rows by the mixed formula, which needs
    Z = 1."""
    n = points.shape[0]
    table = torch.empty((nwin, 2 * n, 24), dtype=torch.int32, device=points.device)
    cur = points
    for w in range(nwin):
        table[w, :n] = cur
        if w < nwin - 1:
            for _ in range(c):
                cur = MK.padd_aos32(cur, cur)
    half = ec.normalize_mont(table[:, :n].reshape(-1, 24)).reshape(nwin, n, 24)
    table[:, :n] = half
    table[:, n:] = ec.endo(half)
    return table


def _cache_key(points, base_key, *shape):
    tag = base_key if base_key is not None else ("at", points.data_ptr())
    return (tag, str(points.device), int(points.shape[0]), *shape)


def fixed_base_table(points: torch.Tensor, c: int, nwin: int, base_key=None) -> torch.Tensor:
    """The LRU-cached [nwin, 2n, 24] window table of `points` (the
    reference's `fixed_base_table`), keyed by (base, device, n, c, nwin).
    base_key (the SRS digest) names the base across calls; without it the
    base is named by its storage address, and the entry keeps the base
    alive."""
    key = _cache_key(points, base_key, int(c), int(nwin))
    ref = None if base_key is not None else points
    hit = TABLES.get(key)
    if hit is not None:
        return hit
    table = build_window_table(points, c, nwin)
    return TABLES.put(key, ref, table, table.numel() * table.element_size())


def expanded_base(points: torch.Tensor, base_key=None) -> torch.Tensor:
    """[P ; phi(P)] of `points`, cached per (base_key, device, n) when the
    base is named."""
    if base_key is None:
        return expand_endo(points)
    key = _cache_key(points, base_key)
    if key not in _EXPANDED:
        _EXPANDED[key] = expand_endo(points)
    return _EXPANDED[key]


# ---------------------------------------------------------------------------
# the MSM
# ---------------------------------------------------------------------------

def _vanilla(points, scalars, c):
    n = points.shape[0]
    c = c or default_window_pallas(n)
    nwin = num_windows(c)
    digits = signed_digit_stream(scalars, c, nwin)
    negs = torch.zeros((1, n), dtype=torch.int32, device=points.device)
    sums = MK.bucket_sums_aos32(points, digits, negs, c)
    return MK.combine_windows(MK.aggregate_buckets_aos32(sums, nwin, 1 << (c - 1)), c)


def _glv(points, scalars, c, base_key):
    points2, mags, negs = glv_split(points, scalars, base_key)
    nwin = num_windows(c, glv.glv_bits())
    digits = signed_digits(mags, c, nwin)
    sums = MK.bucket_sums_aos32(points2, digits, negs, c)
    return MK.combine_windows(MK.aggregate_buckets_aos32(sums, nwin, 1 << (c - 1)), c)


def _fixed(table, mags, negs, c):
    nwin, nb = table.shape[0], 1 << (c - 1)
    digits = signed_digits(mags, c, nwin)
    sums = MK.bucket_sums_fixed_aos32(table, digits, negs, c)
    merged = MK.fold_windows_aos32(sums, nwin, nb)
    return ec.decode_points(MK.aggregate_buckets_aos32(merged, 1, nb))[0]


def msm_aos32(points: torch.Tensor, scalars: torch.Tensor, c: int | None = None,
              mode: str | None = None, base_key=None):
    """points [n, 24] AoS32 Montgomery (the kernels' layout), scalars [n, 4]
    int64 standard form (values < r) -> affine (Fq, Fq) | None, by `mode`
    (default: SPECTRE_MSM_MODE). base_key names a fixed base (the SRS
    digest) for the caches. Kernels on a CUDA device, their plain versions
    on the CPU."""
    n = points.shape[0]
    if scalars.shape != (n, 4):
        raise ValueError(f"scalars: expected [{n}, 4], got {tuple(scalars.shape)}")
    mode = mode if mode is not None else msm_mode()
    if mode not in MSM_MODES:
        raise ValueError(f"unknown MSM mode {mode!r}")
    if mode == "vanilla":
        return _vanilla(points, scalars, c)
    nbits = glv.glv_bits()
    c = c or default_window_pallas(2 * n, signed=True)
    if mode == "fixed" and not _degrade_fixed(n, c, nbits):
        return _fixed(fixed_base_table(points, c, num_windows(c, nbits), base_key),
                      *glv_scalars(scalars), c)
    return _glv(points, scalars, c, base_key)


def msm_base(base: torch.Tensor, scalars_mont: torch.Tensor, c: int | None = None,
             mode: str | None = None, base_key=None):
    """Commitment MSM against a device-resident AoS32 base [N, 24] (N >= m,
    `SRS.device_base`): the first m points, no copy or repack."""
    return msm_aos32(base[:scalars_mont.shape[0]], _std(scalars_mont), c, mode, base_key)


def msm_batch(base: torch.Tensor, scalars_list, c: int | None = None,
              mode: str | None = None, base_key=None) -> list:
    """One commitment MSM per scalar vector, against one base (the
    reference's `msm_batch`); the rows share the cached expanded base or
    window table."""
    mode = mode if mode is not None else msm_mode()
    return [msm_base(base, s, c, mode, base_key) for s in scalars_list]


def _std(scalars_mont: torch.Tensor) -> torch.Tensor:
    return F.from_mont(F.fr_ctx(), scalars_mont.contiguous())


def host_msm(points, scalars):
    """Host oracle: affine points and int scalars -> affine sum."""
    return bn254.g1_curve.msm(points, [int(s) % bn254.R for s in scalars])
