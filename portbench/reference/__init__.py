"""The plain reference that decides `correct`: plain PyTorch and NumPy,
importing nothing of the program. It works the receiver's function out
again from the capture the benchmark made: the front end in float64
(`frontend`), the burst synchroniser (`sync`), the lower-MAC decode
(`fec`) and the upper-MAC walk (`walk_ref`)."""
