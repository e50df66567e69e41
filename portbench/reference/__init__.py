"""The benchmark's plain reference: a frozen copy of the port's eager code
(models, ops, mapping, vertex sampling, AdamW) as it stood when the
benchmark was defined, with the flash-attention path and the map-file I/O
cut out. Its modules import each other and nothing of the port, so that
later changes to the program cannot move what ``correct`` compares with.
Later program PRs leave it as it is."""
