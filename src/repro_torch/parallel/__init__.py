"""The communication layer: the parameter wire format (`wire`), the TRINE
all-reduce schedules over a device mesh with their int8 numerics and byte
model (`collectives`), the GPipe schedule (`pipeline`), the logical-axis
sharding rules and DTensor layouts (`sharding`) and the activation-sharding
context with the tensor-parallel split's operators (`actx`); the wire runs
on one device and over a mesh."""
