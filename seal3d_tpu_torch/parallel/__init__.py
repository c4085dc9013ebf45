"""Multi-rank training: meshes and their logged collectives (mesh.py), and
the launcher that starts the ranks (launch.py)."""
