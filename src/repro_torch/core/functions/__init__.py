"""Set-function families of the port."""
