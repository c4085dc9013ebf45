"""Seal-3D editing over the port (port of seal3d_tpu/seal/): proxy mappers,
the mapped teacher field, occupancy hacks, proxied datasets and the
two-stage student trainer. Every tool is ported (bbox, brush with its line
and curve strokes, anchor) with the colour edits, at any bound; the GUI
that draws them (`--gui`) is not (ROADMAP.md Queue 1, 'GUI state and
scripts')."""
