"""Architecture configurations of the port (one module per architecture,
mirroring ``repro.configs``)."""
