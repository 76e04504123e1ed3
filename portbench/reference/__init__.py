"""Plain PyTorch references of the benchmark's configurations (float32,
TF32 off). They import nothing of the program under test."""
