"""Recsys models: DeepFM (served and trained), two-tower retrieval
(served) and the field-embedding collection they share.  AutoInt and
BST follow their slices in ROADMAP.md."""
