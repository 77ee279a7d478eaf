"""Launch entry points of the model stack, on one device or on a mesh:
the serving steps and their layouts (``serve``), the training step and
its layouts (``train``), the meshes (``mesh``), and the dry run that
traces every production cell on fake devices (``dryrun``, ``fake``)."""
