"""Cost analysis on H100 constants: the roofline model and model-FLOPs
definition (``roofline``), the FLOP / byte / collective counter of one call
(``hlo_cost``), its per-operation attribution (``attribution``) and the live
bytes it follows (``memory``)."""
