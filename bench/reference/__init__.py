"""Plain PyTorch references of the configurations' models (f32, TF32 off).

Each module here is the reference of one family of configurations, named
by the configuration file's `reference` key.  A reference imports nothing
of the program (`repro_torch`), of `jax` or of `repro`: it is written from
the models' published equations and the photonic-MAC numerics the
configuration states, and computes every quantisation again itself.
"""
