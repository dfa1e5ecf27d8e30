"""Entry points of the port: the training launcher (``train``) and its
(data, model) meshes (``mesh``)."""
