"""The circuit builder (the port's copy of `spectre_tpu/builder/`):
halo2-lib's `Context` / `GateChip` / `RangeChip` layer. Circuit logic
appends virtual cells to streams; the layout places the streams into
physical columns (the break points) and yields a plonk.Assignment. The app
circuits (models/) are written against these chips.
"""

from .context import AssignedValue, Context  # noqa: F401
from .gate import GateChip  # noqa: F401
from .range_chip import RangeChip  # noqa: F401
