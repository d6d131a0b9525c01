"""Process groups for the distributed sort (``launch/mesh.py``) and the
server loop (``launch/serve.py``)."""
