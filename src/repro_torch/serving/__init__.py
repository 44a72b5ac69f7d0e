"""Multi-tenant serving over the tiered paged KV cache: the Quest decode
step, the continuous-batching engine and the open-loop driver."""
