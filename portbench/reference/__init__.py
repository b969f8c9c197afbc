"""The plain reference: integer arithmetic, PTQ, events and the operation
and byte counts of each kind of model, in plain PyTorch and NumPy. Nothing
here imports the program under test."""
