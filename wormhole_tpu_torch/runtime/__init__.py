"""Wire, retry, overload and fault layers of the serving tier."""
