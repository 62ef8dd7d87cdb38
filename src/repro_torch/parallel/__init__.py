"""The communication layer on one device: the parameter wire format
(`wire`) and the collectives' int8 numerics and byte model
(`collectives`).  The multi-device schedules, sharding rules, pipeline and
activation constraints of the JAX package's `parallel` are not ported."""
