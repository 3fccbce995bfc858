"""PCD and metadata-CSV writers."""
