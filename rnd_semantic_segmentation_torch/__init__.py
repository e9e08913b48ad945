"""PyTorch and CUDA port of rnd_semantic_segmentation_tpu, for NVIDIA Hopper."""
