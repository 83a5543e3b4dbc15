"""The examples, each run as ``python -m aaclip_tpu_torch.examples.<name>``
as the JAX package's ``examples/<name>.py``: ``zero_shot`` (one image to a
map and a score) and ``synthetic_end_to_end`` (the zero-asset two-stage
demo). Each ``main(argv=None, *, device=None)`` runs on the card unless
``device`` names another."""
