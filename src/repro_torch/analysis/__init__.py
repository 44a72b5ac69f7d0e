"""Cost analysis on H100 constants: the roofline model and model-FLOPs
definition (``roofline``), the FLOP / byte / collective counter of one call
(``hlo_cost``) and its per-operation attribution (``attribution``)."""
