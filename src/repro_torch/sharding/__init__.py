"""SPMD helpers of the port over ``torch.distributed`` (the counterpart of
``repro.sharding``)."""
