"""LM model stack of the port, the dense-GQA serving subset: layers,
flash attention, the transformer's prefill and decode, and the carry-over
of the reference's weights (``convert``)."""
