"""Host-side helpers (image decoding)."""
