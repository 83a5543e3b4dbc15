"""PyTorch and CUDA port of aaclip_tpu: the adapted ViT-L/14-336 inference
path and the fused anomaly map, both training stages (the text adapters
through the text tower and anchors, the image adapters through the
frozen trunk), with hand-written Hopper kernels.

Imports torch, never jax and nothing of aaclip_tpu.
"""
