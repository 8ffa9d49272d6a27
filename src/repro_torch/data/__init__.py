"""Input-data generators (port of ``repro.data``)."""
