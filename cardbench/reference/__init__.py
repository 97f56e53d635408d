"""Plain PyTorch references the benchmark holds the program to. They
import nothing of the program and take nothing it made: each works out
again, from the benchmark's own inputs, what the program derived."""
