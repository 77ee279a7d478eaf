"""Launch entry points of the model stack: the serving steps
(``serve``).  Training, the mesh and the dry run are not ported yet."""
