"""Grid coordinates, the point math of the analysis, and kernel B1 (the
hand-written CUDA grid scan) with its plain PyTorch version."""
