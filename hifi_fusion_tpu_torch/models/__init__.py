"""The fusion pipeline of the port."""
