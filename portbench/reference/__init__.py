"""Plain PyTorch references of the model families, one file a family
(``<family>.py``: ``layout`` and ``block``), and what they share
(``_common.py``).  They import neither JAX nor anything of the program."""
