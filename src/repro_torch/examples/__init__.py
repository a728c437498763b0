"""Port examples: runnable scripts mirroring the reference's
``examples/`` (``three_body``)."""
