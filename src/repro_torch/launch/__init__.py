"""Process groups for the distributed sort (``launch/mesh.py``)."""
