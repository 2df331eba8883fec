"""Test-data generators (host-side numpy)."""
