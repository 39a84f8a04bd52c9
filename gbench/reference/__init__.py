"""The plain references the benchmark judges the program by: plain
PyTorch, importing nothing of the program."""
