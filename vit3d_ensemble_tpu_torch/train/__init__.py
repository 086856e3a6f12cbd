"""The baseline and stacking-ensemble trainers and their pieces."""
