"""Model code of the port: config, common blocks, attention, FFN and the
transformer block with its NODE form."""
