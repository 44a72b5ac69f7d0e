"""Model code of the port: the decoder-only transformer's layers, its
training forward and loss, prefill and contiguous-cache decode, the MoE
block, the tuning flags, and weight conversion from the reference's param
tree."""
