"""Architecture configs (torch dtypes); see base.py."""
