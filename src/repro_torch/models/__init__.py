"""Model code of the port: the dense decoder-only transformer's layers,
prefill and weight conversion from the reference's param tree."""
