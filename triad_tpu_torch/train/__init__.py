"""Training of the port: the 4-group optimizer bank and the train steps
(mirrors ``triad_tpu/train``). This slice trains the text-visual step."""
