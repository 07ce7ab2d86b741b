"""Multi-device rendering: image rows sharded over a group of slabs."""
