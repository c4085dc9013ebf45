"""Seal-3D editing over the port (port of seal3d_tpu/seal/): proxy mappers,
the mapped teacher field, occupancy hacks, proxied datasets and the
two-stage student trainer. The bbox tool is ported with its colour edits;
the brush (with its curve) and anchor tools raise NotImplementedError
(ROADMAP.md Queue 1, 'Seal editing: what stays')."""
