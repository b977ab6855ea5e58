"""The plain references that decide ``correct``: plain NumPy and PyTorch,
importing nothing of the program under test."""
