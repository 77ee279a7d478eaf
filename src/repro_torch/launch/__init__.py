"""Launch entry points of the model stack, on one device or on a mesh:
the serving steps and their layouts (``serve``), the training step and
its layouts (``train``), and the meshes (``mesh``).  The dry run is not
ported yet."""
