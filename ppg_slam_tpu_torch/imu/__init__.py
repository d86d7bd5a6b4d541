from .preintegration import (
    GRAVITY_VALUE,
    PreintState,
    Preintegrated,
    corrected_deltas,
    integrate,
)

__all__ = [
    "GRAVITY_VALUE",
    "PreintState",
    "Preintegrated",
    "corrected_deltas",
    "integrate",
]
