"""ALERT core: runtime controller (paper Section 3) and anytime nesting
(paper Section 4), ported to PyTorch."""
