"""Counter plans and the counter kernel of the pairwise sweep."""
