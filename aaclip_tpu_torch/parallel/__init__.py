"""Data, tensor, sequence and pipeline parallelism over
``torch.distributed``: one process per card, the JAX package's device
mesh as process groups (``sharding.py``), the Megatron layout of the
towers' blocks (``tensor.py``) and the GPipe stages of the trunk
(``pipeline.py``)."""
