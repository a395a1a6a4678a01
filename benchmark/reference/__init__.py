"""Plain PyTorch references, one module a semantics, named by a
configuration's ``reference`` key.  Nothing here imports the program."""
