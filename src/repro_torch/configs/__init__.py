"""Model configurations of the ported slice (the paper's CNN and MLP)."""
