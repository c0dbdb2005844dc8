"""The circuit builder (the port's copy of `spectre_tpu/builder/`):
halo2-lib's `Context` / `GateChip` / `RangeChip` layer. Circuit logic
appends virtual cells to streams; the layout places the streams into
physical columns (the break points) and yields a plonk.Assignment. The app
circuits (models/) are written against these chips; the non-native
BLS12-381 chips (bigint, fp_chip, fp2_chip, fp12_chip, pairing_chip,
hash_to_curve_chip) are imported from their modules.
"""

from .context import AssignedValue, Context  # noqa: F401
from .gate import GateChip  # noqa: F401
from .range_chip import RangeChip  # noqa: F401
