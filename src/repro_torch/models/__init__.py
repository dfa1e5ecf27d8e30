"""The model substrate: configuration, layers and the ported families."""
