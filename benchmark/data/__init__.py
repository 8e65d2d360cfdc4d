"""Generators of a cell's inputs, one file a kind, found by the ``kind`` that a
configuration's ``data`` block or a traffic's ``row_inputs`` names."""
