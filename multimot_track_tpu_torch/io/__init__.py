"""Host-side frame records and synthetic scenes (numpy)."""
