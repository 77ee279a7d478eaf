"""Launch entry points of the model stack on one device: the serving
steps (``serve``) and the training step (``train``).  The mesh and the
dry run are not ported yet."""
