"""The plain reference: the paper's step in float64 PyTorch and Theorem 1's
noise scale in numpy. It imports nothing of the program under test."""
