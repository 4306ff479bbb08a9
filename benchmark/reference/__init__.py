"""The plain reference: NumPy and plain PyTorch, float32, TF32 off.  It
imports nothing of ``wire_tpu_torch`` and takes nothing the program made:
it works out the inputs, the init, the model, the operator and Adam again
from the fit's seed and the numbers of the cell's files."""
