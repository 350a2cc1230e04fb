"""Launchers: the serving engine and the serving CLI.  Nothing in the
package touches the card at import time."""
