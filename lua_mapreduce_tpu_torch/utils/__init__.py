"""Small shared utilities (statistics)."""
