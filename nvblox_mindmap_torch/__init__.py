"""PyTorch / CUDA port of nvblox_mindmap_tpu for NVIDIA Hopper GPUs."""
