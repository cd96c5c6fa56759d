"""GNN models of the port."""
