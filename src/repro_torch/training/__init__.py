"""Training: optimizers, the fault-tolerant loop, step-atomic
checkpoints and int8 gradient compression.

Port of ``repro/training/``.  State trees are nested dictionaries,
lists and tuples of tensors with ``repro``'s pytree layout, so the two
packages' checkpoints and optimizer states line up leaf for leaf.
"""
