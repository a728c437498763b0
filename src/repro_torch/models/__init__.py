"""Model code of the port: config, common blocks, attention, RG-LRU, FFN,
the transformer stack with the node18 block and its NODE form, and the LM
(``lm.build_model``)."""
