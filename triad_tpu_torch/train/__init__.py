"""Training of the port (mirrors ``triad_tpu/train``): the 4-group
optimizer bank (``optim``), the three train steps of the curriculum and
the eval loss (``step``), checkpoints with an exact mid-epoch resume
(``checkpoint``), and the Trainer that runs the curriculum from its data
through validation, retrieval, viz and checkpoints (``trainer``).
Importing the package imports none of them."""
