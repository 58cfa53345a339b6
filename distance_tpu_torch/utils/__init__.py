"""Host-side utilities (timing/observability)."""
