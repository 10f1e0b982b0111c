"""The remote model layer: the wire protocol, the clients and the model server."""
