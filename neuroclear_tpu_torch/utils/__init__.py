"""Host-side helpers: weights across the two packages, dicing pads."""
