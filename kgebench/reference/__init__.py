"""The plain reference: plain PyTorch and numpy, importing nothing of the
program, that works out again what a cell's window must produce."""
