"""Launch drivers of the port (port of ``repro.launch``): the host's mesh
(``mesh``) and the end-to-end training driver (``train``)."""
