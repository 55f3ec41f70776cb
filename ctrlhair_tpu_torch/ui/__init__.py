# The user-facing frontends of the port: web.py (browser, stdlib HTTP),
# demo.py (headless demo and the tkinter launcher) and app.py (tkinter).
