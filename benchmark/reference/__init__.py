"""The plain reference: frozen copies of the port's plain path and the
solver, replan core and comparisons written in plain PyTorch; it imports
nothing of `qtos_torch`."""
