"""Host helpers."""
