"""LM model stack of the port, the serving subset: layers (MoE
included), flash attention, Mamba-1 blocks (``ssm``), the transformer's
prefill and decode, and the carry-over of the reference's weights
(``convert``)."""
