"""Result fields each serving mode ships after the x1/x2 audio echo
(wire order, reference README.md:160-219)."""

RESULT_KEYS = {
    "vap": ("p_now", "p_future", "vad"),
    "bc": ("p_bc_react", "p_bc_emo"),
    "nod": ("p_bc", "p_nod_short", "p_nod_long", "p_nod_long_p"),
}
