"""Data, tensor and sequence parallelism over ``torch.distributed``: one
process per card, the JAX package's device mesh as process groups
(``sharding.py``) and the Megatron layout of the towers' blocks
(``tensor.py``)."""
