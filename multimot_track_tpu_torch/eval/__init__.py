"""Online ground-truth metrics."""
