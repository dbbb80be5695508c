"""LM training on one device (port of ``repro.train``): the train step
(``loop.make_train_step``), checkpoints in the JAX package's layout
(``checkpoint``) and the fault-tolerance helpers (``fault``)."""
