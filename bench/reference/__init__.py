"""Plain references in PyTorch: they import nothing of the program."""
