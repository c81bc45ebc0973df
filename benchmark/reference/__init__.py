"""The plain reference: per-row Poisson problems and top-N rankings in
float64 PyTorch.  Nothing here imports the program under test; it works
out again whatever the program derives (row lists, Bsum, orderings)
from the inputs the benchmark made."""
