"""Multi-device counting and lookups (`parallel/mesh.py`)."""
