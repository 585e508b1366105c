"""Entry points of the port (counterparts of ``koordinator_tpu/cmd``)."""
