"""Data-parallel training over a ``torch.distributed`` process group
(counterpart of ``mbt_gym_tpu/parallel/``)."""
