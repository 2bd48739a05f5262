"""Multi-device execution of the VBHEM engine over ``torch.distributed``
(:mod:`.spmd`)."""
