"""Node sharding of the solve (counterpart of ``koordinator_tpu/parallel``)."""
