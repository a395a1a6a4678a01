"""One module an entry point of the program that a traffic mix can name
(``"entry": "<name>"``): ``entries/<name>.py`` defines ``program(cell,
device) -> (prepare, solve)`` and optionally ``to_result(out)``."""
