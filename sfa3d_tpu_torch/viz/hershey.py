"""The port's FONT_HERSHEY_SIMPLEX, as cv2 5.x draws it: an anti-aliased
outline font (regular below thickness 2, bold from 2), owned by the port
and used by `viz/raster.py`'s `get_text_size` and `put_text`.

Generated by `scripts/torch_hershey_table.py` from cv2's own `getTextSize`
and `putText`. Per weight and printable ASCII character (32-126) it
holds, at the pixel sizes 14, 22 and 27 (fontScale 0.5, 0.8 and 1.0),
the whole-pixel advance, the descent, and the glyph's coverage block:
its top-left pixel relative to the pen's pixel on the baseline, its
size, and its offset in the zlib-compressed coverage bytes. A character
outside 32-126 draws as '?'.
"""

import base64
import zlib
from functools import lru_cache

import numpy as np

HEIGHT = 27027  # the pixel size is round(HEIGHT / 1000 * fontScale)
SIZES = (14, 22, 27)  # the tabulated pixel sizes

# weight -> character -> {size: (advance, descent, x0, y0, w, h, offset)}
_TABLE = {
    'regular': {
        ' ': {14: (3, 0, 0, 0, 0, 0, 0), 22: (6, 0, 0, 0, 0, 0, 0), 27: (7, 0, 0, 0, 0, 0, 0)},
        '!': {14: (3, 0, 1, -11, 2, 11, 0), 22: (5, 0, 1, -17, 4, 17, 22), 27: (7, 0, 1, -21, 5, 21, 90)},
        '"': {14: (5, 0, 0, -11, 5, 4, 195), 22: (8, 0, 1, -17, 7, 6, 215), 27: (10, 0, 1, -21, 9, 7, 257)},
        '#': {14: (10, 0, 0, -10, 10, 10, 320), 22: (16, 0, 1, -16, 15, 16, 420), 27: (20, 0, 1, -19, 18, 18, 660)},
        '$': {14: (9, 2, 0, -12, 9, 14, 984), 22: (14, 3, 0, -19, 14, 22, 1110), 27: (17, 3, 1, -24, 16, 27, 1418)},
        '%': {14: (11, 1, 0, -11, 11, 12, 1850), 22: (17, 1, 1, -17, 16, 18, 1982), 27: (21, 1, 1, -21, 20, 22, 2270)},
        '&': {14: (10, 1, 0, -11, 10, 12, 2710), 22: (16, 1, 1, -17, 15, 18, 2830), 27: (20, 1, 1, -21, 19, 22, 3100)},
        "'": {14: (3, 0, 0, -11, 3, 4, 3518), 22: (5, 0, 1, -17, 3, 6, 3530), 27: (6, 0, 1, -21, 4, 7, 3548)},
        '(': {14: (9, 2, 2, -13, 5, 15, 3576), 22: (14, 3, 4, -20, 7, 23, 3651), 27: (17, 4, 5, -24, 8, 28, 3812)},
        ')': {14: (9, 2, 2, -13, 5, 15, 4036), 22: (14, 3, 3, -20, 8, 23, 4111), 27: (17, 4, 4, -24, 9, 28, 4295)},
        '*': {14: (6, 0, 0, -11, 6, 5, 4547), 22: (10, 0, 1, -18, 9, 9, 4577), 27: (12, 0, 1, -22, 11, 11, 4658)},
        '+': {14: (9, 0, 0, -9, 9, 9, 4779), 22: (14, 0, 0, -14, 14, 14, 4860), 27: (17, 0, 1, -17, 16, 17, 5056)},
        ',': {14: (3, 2, 0, -2, 3, 4, 5328), 22: (5, 2, 1, -3, 4, 5, 5340), 27: (7, 3, 1, -4, 5, 7, 5360)},
        '-': {14: (7, 0, 1, -6, 6, 3, 5395), 22: (11, 0, 1, -9, 9, 3, 5413), 27: (13, 0, 1, -10, 11, 3, 5440)},
        '.': {14: (3, 0, 1, -2, 2, 2, 5473), 22: (5, 0, 1, -3, 4, 3, 5477), 27: (7, 0, 1, -4, 5, 4, 5489)},
        '/': {14: (7, 2, 0, -12, 7, 14, 5509), 22: (11, 2, 0, -19, 11, 21, 5607), 27: (13, 3, 0, -23, 14, 26, 5838)},
        '0': {14: (9, 1, 0, -11, 9, 12, 6202), 22: (14, 1, 1, -17, 13, 18, 6310), 27: (17, 1, 1, -21, 16, 22, 6544)},
        '1': {14: (9, 0, 1, -11, 8, 11, 6896), 22: (14, 0, 2, -17, 12, 17, 6984), 27: (17, 0, 2, -21, 15, 21, 7188)},
        '2': {14: (9, 0, 0, -11, 9, 11, 7503), 22: (14, 0, 1, -17, 12, 17, 7602), 27: (17, 0, 1, -21, 15, 21, 7806)},
        '3': {14: (9, 1, 0, -11, 9, 12, 8121), 22: (14, 1, 1, -17, 13, 18, 8229), 27: (17, 1, 1, -21, 16, 22, 8463)},
        '4': {14: (9, 0, 0, -11, 9, 11, 8815), 22: (14, 0, 0, -17, 14, 17, 8914), 27: (17, 0, 0, -21, 17, 21, 9152)},
        '5': {14: (9, 1, 0, -11, 9, 12, 9509), 22: (14, 1, 1, -17, 13, 18, 9617), 27: (17, 1, 1, -21, 16, 22, 9851)},
        '6': {14: (9, 1, 0, -11, 9, 12, 10203), 22: (14, 1, 1, -17, 13, 18, 10311), 27: (17, 1, 1, -21, 16, 22, 10545)},
        '7': {14: (9, 0, 1, -11, 8, 11, 10897), 22: (14, 0, 1, -17, 12, 17, 10985), 27: (17, 0, 2, -21, 14, 21, 11189)},
        '8': {14: (9, 1, 0, -11, 9, 12, 11483), 22: (14, 1, 1, -17, 13, 18, 11591), 27: (17, 1, 1, -21, 16, 22, 11825)},
        '9': {14: (9, 0, 0, -11, 9, 11, 12177), 22: (14, 0, 1, -17, 13, 17, 12276), 27: (17, 0, 1, -21, 16, 21, 12497)},
        ':': {14: (3, 0, 1, -7, 2, 7, 12833), 22: (6, 0, 1, -11, 4, 11, 12847), 27: (7, 0, 1, -14, 5, 14, 12891)},
        ';': {14: (4, 2, 0, -7, 3, 9, 12961), 22: (6, 2, 1, -11, 4, 13, 12988), 27: (7, 3, 1, -14, 5, 17, 13040)},
        '<': {14: (7, 0, 0, -9, 7, 9, 13125), 22: (11, 0, 0, -14, 10, 14, 13188), 27: (14, 0, 1, -17, 12, 17, 13328)},
        '=': {14: (8, 0, 1, -7, 7, 5, 13532), 22: (13, 0, 1, -11, 11, 8, 13567), 27: (16, 0, 2, -14, 13, 11, 13655)},
        '>': {14: (7, 0, 1, -9, 6, 9, 13798), 22: (11, 0, 1, -14, 10, 14, 13852), 27: (14, 0, 1, -17, 13, 17, 13992)},
        '?': {14: (7, 0, 0, -11, 8, 11, 14213), 22: (12, 0, 0, -17, 12, 17, 14301), 27: (15, 0, 0, -21, 15, 21, 14505)},
        '@': {14: (12, 2, 0, -10, 12, 12, 14820), 22: (19, 3, 1, -16, 18, 19, 14964), 27: (24, 4, 1, -20, 22, 24, 15306)},
        'A': {14: (10, 0, 0, -11, 10, 11, 15834), 22: (15, 0, 0, -17, 16, 17, 15944), 27: (19, 0, 0, -21, 19, 21, 16216)},
        'B': {14: (10, 0, 1, -11, 9, 11, 16615), 22: (15, 0, 2, -17, 13, 17, 16714), 27: (19, 0, 2, -21, 16, 21, 16935)},
        'C': {14: (9, 1, 0, -11, 10, 12, 17271), 22: (15, 1, 1, -17, 14, 18, 17391), 27: (19, 1, 1, -21, 17, 22, 17643)},
        'D': {14: (10, 0, 1, -11, 9, 11, 18017), 22: (16, 0, 2, -17, 13, 17, 18116), 27: (19, 0, 2, -21, 17, 21, 18337)},
        'E': {14: (9, 0, 1, -11, 8, 11, 18694), 22: (14, 0, 2, -17, 12, 17, 18782), 27: (17, 0, 2, -21, 14, 21, 18986)},
        'F': {14: (8, 0, 1, -11, 8, 11, 19280), 22: (13, 0, 2, -17, 11, 17, 19368), 27: (16, 0, 2, -21, 14, 21, 19555)},
        'G': {14: (10, 1, 0, -11, 10, 12, 19849), 22: (16, 1, 1, -17, 14, 18, 19969), 27: (19, 1, 1, -21, 18, 22, 20221)},
        'H': {14: (10, 0, 1, -11, 9, 11, 20617), 22: (16, 0, 2, -17, 13, 17, 20716), 27: (20, 0, 2, -21, 17, 21, 20937)},
        'I': {14: (4, 0, 1, -11, 2, 11, 21294), 22: (6, 0, 2, -17, 3, 17, 21316), 27: (7, 0, 2, -21, 4, 21, 21367)},
        'J': {14: (9, 1, 0, -11, 9, 12, 21451), 22: (14, 1, 0, -17, 14, 18, 21559), 27: (18, 1, 1, -21, 15, 22, 21811)},
        'K': {14: (9, 0, 1, -11, 8, 11, 22141), 22: (14, 0, 2, -17, 12, 17, 22229), 27: (17, 0, 2, -21, 15, 21, 22433)},
        'L': {14: (8, 0, 1, -11, 8, 11, 22748), 22: (13, 0, 2, -17, 11, 17, 22836), 27: (16, 0, 2, -21, 14, 21, 23023)},
        'M': {14: (11, 0, 1, -11, 10, 11, 23317), 22: (18, 0, 2, -17, 15, 17, 23427), 27: (22, 0, 2, -21, 19, 21, 23682)},
        'N': {14: (10, 0, 1, -11, 9, 11, 24081), 22: (16, 0, 2, -17, 13, 17, 24180), 27: (20, 0, 2, -21, 16, 21, 24401)},
        'O': {14: (10, 1, 0, -11, 10, 12, 24737), 22: (15, 1, 1, -17, 14, 18, 24857), 27: (19, 1, 1, -21, 17, 22, 25109)},
        'P': {14: (9, 0, 1, -11, 9, 11, 25483), 22: (15, 0, 2, -17, 13, 17, 25582), 27: (18, 0, 2, -21, 16, 21, 25803)},
        'Q': {14: (10, 1, 0, -11, 10, 12, 26139), 22: (15, 2, 1, -17, 14, 19, 26259), 27: (19, 2, 1, -21, 17, 23, 26525)},
        'R': {14: (9, 0, 1, -11, 9, 11, 26916), 22: (15, 0, 2, -17, 13, 17, 27015), 27: (18, 0, 2, -21, 16, 21, 27236)},
        'S': {14: (9, 1, 0, -11, 9, 12, 27572), 22: (14, 1, 1, -17, 13, 18, 27680), 27: (17, 1, 1, -21, 16, 22, 27914)},
        'T': {14: (8, 0, 0, -11, 9, 11, 28266), 22: (13, 0, 0, -17, 14, 17, 28365), 27: (16, 0, 0, -21, 16, 21, 28603)},
        'U': {14: (10, 1, 1, -11, 9, 12, 28939), 22: (16, 1, 1, -17, 14, 18, 29047), 27: (20, 1, 2, -21, 16, 22, 29299)},
        'V': {14: (9, 0, 0, -11, 10, 11, 29651), 22: (15, 0, 0, -17, 15, 17, 29761), 27: (18, 0, 0, -21, 18, 21, 30016)},
        'W': {14: (11, 0, 0, -11, 12, 11, 30394), 22: (18, 0, 1, -17, 17, 17, 30526), 27: (23, 0, 1, -21, 21, 21, 30815)},
        'X': {14: (9, 0, 0, -11, 10, 11, 31256), 22: (14, 0, 0, -17, 15, 17, 31366), 27: (18, 0, 0, -21, 18, 21, 31621)},
        'Y': {14: (9, 0, 0, -11, 10, 11, 31999), 22: (15, 0, 0, -17, 15, 17, 32109), 27: (18, 0, 0, -21, 18, 21, 32364)},
        'Z': {14: (8, 0, 0, -11, 9, 11, 32742), 22: (14, 0, 0, -17, 14, 17, 32841), 27: (17, 0, 1, -21, 16, 21, 33079)},
        '[': {14: (4, 3, 1, -12, 4, 15, 33415), 22: (7, 4, 1, -19, 7, 23, 33475), 27: (9, 5, 2, -23, 7, 28, 33636)},
        '\\': {14: (7, 2, 0, -12, 7, 14, 33832), 22: (11, 2, 0, -19, 11, 21, 33930), 27: (13, 3, 0, -23, 14, 26, 34161)},
        ']': {14: (4, 3, 0, -12, 4, 15, 34525), 22: (7, 4, 0, -19, 6, 23, 34585), 27: (9, 5, 0, -23, 8, 28, 34723)},
        '^': {14: (6, 0, 1, -11, 5, 3, 34947), 22: (10, 0, 1, -17, 8, 4, 34962), 27: (12, 0, 1, -21, 10, 5, 34994)},
        '_': {14: (11, 1, 0, -1, 11, 2, 35044), 22: (17, 1, 1, -1, 16, 2, 35066), 27: (21, 2, 1, -2, 19, 4, 35098)},
        '`': {14: (5, 0, 1, -11, 4, 3, 35174), 22: (7, 0, 1, -18, 6, 4, 35186), 27: (9, 0, 1, -22, 7, 5, 35210)},
        'a': {14: (8, 1, 0, -8, 8, 9, 35245), 22: (12, 1, 0, -13, 12, 14, 35317), 27: (15, 1, 1, -16, 13, 17, 35485)},
        'b': {14: (8, 1, 1, -11, 8, 12, 35706), 22: (14, 1, 1, -17, 12, 18, 35802), 27: (17, 1, 2, -21, 14, 22, 36018)},
        'c': {14: (8, 1, 0, -8, 8, 9, 36326), 22: (12, 1, 1, -13, 11, 14, 36398), 27: (15, 1, 1, -16, 14, 17, 36552)},
        'd': {14: (8, 1, 0, -11, 8, 12, 36790), 22: (14, 1, 1, -17, 12, 18, 36886), 27: (17, 1, 1, -21, 15, 22, 37102)},
        'e': {14: (8, 1, 0, -8, 8, 9, 37432), 22: (13, 1, 1, -13, 12, 14, 37504), 27: (16, 1, 1, -16, 14, 17, 37672)},
        'f': {14: (5, 0, 0, -12, 6, 12, 37910), 22: (9, 0, 0, -18, 9, 18, 37982), 27: (11, 0, 0, -22, 11, 22, 38144)},
        'g': {14: (8, 4, 0, -8, 8, 12, 38386), 22: (14, 6, 1, -13, 12, 19, 38482), 27: (17, 7, 1, -16, 15, 23, 38710)},
        'h': {14: (9, 0, 1, -11, 8, 11, 39055), 22: (14, 0, 1, -17, 12, 17, 39143), 27: (17, 0, 2, -21, 14, 21, 39347)},
        'i': {14: (3, 0, 0, -11, 3, 11, 39641), 22: (5, 0, 1, -17, 4, 17, 39674), 27: (6, 0, 1, -21, 5, 21, 39742)},
        'j': {14: (3, 3, -1, -11, 4, 14, 39847), 22: (5, 5, -1, -17, 6, 22, 39903), 27: (7, 6, -2, -21, 8, 27, 40035)},
        'k': {14: (7, 0, 1, -11, 7, 11, 40251), 22: (12, 0, 1, -17, 11, 17, 40328), 27: (14, 0, 2, -21, 13, 21, 40515)},
        'l': {14: (3, 0, 1, -11, 2, 11, 40788), 22: (5, 0, 1, -17, 3, 17, 40810), 27: (7, 0, 2, -21, 3, 21, 40861)},
        'm': {14: (13, 0, 1, -8, 12, 8, 40924), 22: (20, 0, 1, -13, 19, 13, 41020), 27: (25, 0, 2, -16, 22, 16, 41267)},
        'n': {14: (9, 0, 1, -8, 8, 8, 41619), 22: (14, 0, 1, -13, 12, 13, 41683), 27: (17, 0, 2, -16, 14, 16, 41839)},
        'o': {14: (8, 1, 0, -8, 8, 9, 42063), 22: (13, 1, 1, -13, 12, 14, 42135), 27: (16, 1, 1, -16, 15, 17, 42303)},
        'p': {14: (8, 3, 1, -8, 8, 11, 42558), 22: (14, 5, 1, -13, 12, 18, 42646), 27: (17, 6, 2, -16, 14, 22, 42862)},
        'q': {14: (8, 3, 0, -8, 8, 11, 43170), 22: (14, 5, 1, -13, 12, 18, 43258), 27: (17, 6, 1, -16, 15, 22, 43474)},
        'r': {14: (5, 0, 1, -8, 5, 8, 43804), 22: (8, 0, 1, -13, 8, 13, 43844), 27: (10, 0, 2, -16, 9, 16, 43948)},
        's': {14: (7, 1, 0, -8, 7, 9, 44092), 22: (12, 1, 1, -13, 10, 14, 44155), 27: (14, 1, 1, -16, 13, 17, 44295)},
        't': {14: (5, 0, 0, -11, 6, 11, 44516), 22: (9, 0, 0, -17, 9, 17, 44582), 27: (11, 0, 0, -21, 11, 21, 44735)},
        'u': {14: (9, 1, 1, -8, 7, 9, 44966), 22: (14, 1, 1, -13, 12, 14, 45029), 27: (17, 1, 1, -16, 15, 17, 45197)},
        'v': {14: (8, 0, 0, -8, 8, 8, 45452), 22: (13, 0, 0, -13, 13, 13, 45516), 27: (15, 0, 0, -16, 16, 16, 45685)},
        'w': {14: (12, 0, 0, -8, 12, 8, 45941), 22: (18, 0, 0, -13, 18, 13, 46037), 27: (23, 0, 1, -16, 22, 16, 46271)},
        'x': {14: (8, 0, 0, -8, 8, 8, 46623), 22: (12, 0, 0, -13, 12, 13, 46687), 27: (15, 0, 0, -16, 15, 16, 46843)},
        'y': {14: (8, 3, 0, -8, 8, 11, 47083), 22: (12, 5, 0, -13, 13, 18, 47171), 27: (15, 6, 0, -16, 16, 22, 47405)},
        'z': {14: (7, 0, 0, -8, 8, 8, 47757), 22: (11, 0, 0, -13, 12, 13, 47821), 27: (14, 0, 1, -16, 13, 16, 47977)},
        '{': {14: (5, 3, 0, -12, 6, 15, 48185), 22: (8, 4, 0, -19, 9, 23, 48275), 27: (10, 5, 0, -23, 10, 28, 48482)},
        '|': {14: (3, 4, 1, -14, 2, 18, 48762), 22: (5, 5, 1, -22, 3, 27, 48798), 27: (6, 7, 2, -26, 3, 33, 48879)},
        '}': {14: (5, 3, 0, -12, 6, 15, 48978), 22: (8, 4, 0, -19, 8, 23, 49068), 27: (10, 5, 0, -23, 10, 28, 49252)},
        '~': {14: (8, 0, 1, -6, 7, 3, 49532), 22: (13, 0, 1, -9, 11, 4, 49553), 27: (16, 0, 2, -11, 13, 5, 49597)},
    },
    'bold': {
        ' ': {14: (3, 0, 0, 0, 0, 0, 49662), 22: (6, 0, 0, 0, 0, 0, 49662), 27: (7, 0, 0, 0, 0, 0, 49662)},
        '!': {14: (4, 0, 0, -11, 4, 11, 49662), 22: (6, 0, 1, -17, 5, 17, 49706), 27: (8, 0, 1, -21, 6, 21, 49791)},
        '"': {14: (6, 0, 0, -11, 6, 5, 49917), 22: (10, 0, 1, -17, 9, 7, 49947), 27: (12, 0, 1, -21, 11, 8, 50010)},
        '#': {14: (10, 0, 0, -10, 10, 10, 50098), 22: (16, 0, 1, -16, 15, 16, 50198), 27: (19, 0, 1, -19, 18, 18, 50438)},
        '$': {14: (9, 2, 0, -12, 10, 14, 50762), 22: (15, 3, 0, -19, 15, 22, 50902), 27: (18, 3, 1, -24, 17, 27, 51232)},
        '%': {14: (11, 1, 0, -11, 12, 12, 51691), 22: (18, 1, 0, -17, 18, 18, 51835), 27: (22, 1, 1, -21, 21, 22, 52159)},
        '&': {14: (10, 1, 0, -11, 11, 12, 52621), 22: (17, 1, 1, -17, 16, 18, 52753), 27: (21, 1, 1, -21, 20, 22, 53041)},
        "'": {14: (3, 0, 0, -11, 3, 5, 53481), 22: (5, 0, 1, -17, 4, 7, 53496), 27: (6, 0, 1, -21, 5, 8, 53524)},
        '(': {14: (9, 2, 2, -13, 6, 15, 53564), 22: (15, 3, 4, -20, 8, 23, 53654), 27: (18, 4, 5, -24, 9, 28, 53838)},
        ')': {14: (9, 2, 2, -13, 6, 15, 54090), 22: (15, 3, 3, -20, 9, 23, 54180), 27: (18, 4, 4, -24, 10, 28, 54387)},
        '*': {14: (6, 0, 0, -11, 6, 6, 54667), 22: (10, 0, 1, -18, 9, 9, 54703), 27: (12, 0, 1, -22, 11, 11, 54784)},
        '+': {14: (9, 0, 0, -9, 9, 9, 54905), 22: (14, 0, 0, -14, 14, 14, 54986), 27: (17, 0, 1, -17, 16, 17, 55182)},
        ',': {14: (4, 2, 0, -3, 4, 5, 55454), 22: (6, 2, 0, -4, 6, 6, 55474), 27: (7, 3, 1, -5, 6, 8, 55510)},
        '-': {14: (7, 0, 0, -6, 7, 3, 55558), 22: (11, 0, 1, -9, 9, 4, 55579), 27: (13, 0, 1, -11, 12, 5, 55615)},
        '.': {14: (4, 0, 0, -3, 4, 3, 55675), 22: (6, 0, 1, -4, 5, 4, 55687), 27: (7, 0, 1, -5, 6, 5, 55707)},
        '/': {14: (7, 2, 0, -12, 8, 14, 55737), 22: (12, 2, 0, -19, 12, 21, 55849), 27: (15, 3, 0, -23, 15, 26, 56101)},
        '0': {14: (9, 1, 0, -11, 10, 12, 56491), 22: (15, 1, 1, -17, 14, 18, 56611), 27: (18, 1, 1, -21, 17, 22, 56863)},
        '1': {14: (9, 0, 1, -11, 8, 11, 57237), 22: (15, 0, 1, -17, 14, 17, 57325), 27: (18, 0, 1, -21, 17, 21, 57563)},
        '2': {14: (9, 0, 0, -11, 9, 11, 57920), 22: (15, 0, 1, -17, 14, 17, 58019), 27: (18, 0, 1, -21, 17, 21, 58257)},
        '3': {14: (9, 1, 0, -11, 10, 12, 58614), 22: (15, 1, 0, -17, 15, 18, 58734), 27: (18, 1, 1, -21, 17, 22, 59004)},
        '4': {14: (9, 0, 0, -11, 10, 11, 59378), 22: (15, 0, 0, -17, 15, 17, 59488), 27: (18, 0, 0, -21, 19, 21, 59743)},
        '5': {14: (9, 1, 0, -11, 10, 12, 60142), 22: (15, 1, 1, -17, 14, 18, 60262), 27: (18, 1, 1, -21, 17, 22, 60514)},
        '6': {14: (9, 1, 0, -11, 10, 12, 60888), 22: (15, 1, 1, -17, 14, 18, 61008), 27: (18, 1, 1, -21, 17, 22, 61260)},
        '7': {14: (9, 0, 1, -11, 8, 11, 61634), 22: (15, 0, 1, -17, 13, 17, 61722), 27: (18, 0, 2, -21, 15, 21, 61943)},
        '8': {14: (9, 1, 0, -11, 10, 12, 62258), 22: (15, 1, 0, -17, 15, 18, 62378), 27: (18, 1, 1, -21, 17, 22, 62648)},
        '9': {14: (9, 0, 0, -11, 9, 11, 63022), 22: (15, 0, 1, -17, 14, 17, 63121), 27: (18, 0, 1, -21, 17, 21, 63359)},
        ':': {14: (4, 0, 0, -8, 4, 8, 63716), 22: (6, 0, 1, -12, 5, 12, 63748), 27: (8, 0, 1, -15, 6, 15, 63808)},
        ';': {14: (4, 2, 0, -8, 4, 10, 63898), 22: (6, 2, 1, -12, 5, 14, 63938), 27: (8, 3, 1, -15, 6, 18, 64008)},
        '<': {14: (7, 0, 0, -10, 7, 10, 64116), 22: (12, 0, 0, -15, 11, 15, 64186), 27: (14, 0, 0, -18, 13, 18, 64351)},
        '=': {14: (8, 0, 0, -8, 8, 7, 64585), 22: (13, 0, 1, -12, 11, 10, 64641), 27: (16, 0, 1, -14, 14, 11, 64751)},
        '>': {14: (7, 0, 0, -10, 8, 10, 64905), 22: (11, 0, 1, -15, 11, 15, 64985), 27: (14, 0, 1, -18, 13, 18, 65150)},
        '?': {14: (8, 0, 0, -11, 9, 11, 65384), 22: (13, 0, 0, -17, 13, 17, 65483), 27: (16, 0, 0, -21, 16, 21, 65704)},
        '@': {14: (12, 2, 0, -11, 12, 13, 66040), 22: (19, 3, 1, -16, 18, 19, 66196), 27: (24, 4, 1, -20, 22, 24, 66538)},
        'A': {14: (10, 0, 0, -11, 11, 11, 67066), 22: (16, 0, 0, -17, 17, 17, 67187), 27: (20, 0, 0, -21, 20, 21, 67476)},
        'B': {14: (10, 0, 1, -11, 9, 11, 67896), 22: (16, 0, 1, -17, 15, 17, 67995), 27: (20, 0, 2, -21, 17, 21, 68250)},
        'C': {14: (10, 1, 0, -11, 10, 12, 68607), 22: (16, 1, 1, -17, 15, 18, 68727), 27: (20, 1, 1, -21, 18, 22, 68997)},
        'D': {14: (10, 0, 1, -11, 9, 11, 69393), 22: (16, 0, 1, -17, 15, 17, 69492), 27: (20, 0, 2, -21, 17, 21, 69747)},
        'E': {14: (9, 0, 1, -11, 8, 11, 70104), 22: (14, 0, 1, -17, 13, 17, 70192), 27: (18, 0, 2, -21, 15, 21, 70413)},
        'F': {14: (9, 0, 1, -11, 8, 11, 70728), 22: (14, 0, 1, -17, 13, 17, 70816), 27: (17, 0, 2, -21, 15, 21, 71037)},
        'G': {14: (10, 1, 0, -11, 10, 12, 71352), 22: (16, 1, 1, -17, 15, 18, 71472), 27: (20, 1, 1, -21, 19, 22, 71742)},
        'H': {14: (11, 0, 1, -11, 9, 11, 72160), 22: (17, 0, 1, -17, 15, 17, 72259), 27: (21, 0, 2, -21, 18, 21, 72514)},
        'I': {14: (4, 0, 1, -11, 3, 11, 72892), 22: (7, 0, 1, -17, 5, 17, 72925), 27: (8, 0, 2, -21, 5, 21, 73010)},
        'J': {14: (9, 1, 0, -11, 9, 12, 73115), 22: (15, 1, 0, -17, 14, 18, 73223), 27: (19, 1, 0, -21, 18, 22, 73475)},
        'K': {14: (9, 0, 1, -11, 9, 11, 73871), 22: (15, 0, 1, -17, 14, 17, 73970), 27: (18, 0, 2, -21, 17, 21, 74208)},
        'L': {14: (8, 0, 1, -11, 8, 11, 74565), 22: (13, 0, 1, -17, 13, 17, 74653), 27: (16, 0, 2, -21, 15, 21, 74874)},
        'M': {14: (12, 0, 1, -11, 11, 11, 75189), 22: (19, 0, 1, -17, 17, 17, 75310), 27: (23, 0, 2, -21, 20, 21, 75599)},
        'N': {14: (10, 0, 1, -11, 9, 11, 76019), 22: (16, 0, 1, -17, 15, 17, 76118), 27: (20, 0, 2, -21, 17, 21, 76373)},
        'O': {14: (10, 1, 0, -11, 10, 12, 76730), 22: (16, 1, 1, -17, 15, 18, 76850), 27: (20, 1, 1, -21, 18, 22, 77120)},
        'P': {14: (9, 0, 1, -11, 9, 11, 77516), 22: (15, 0, 1, -17, 14, 17, 77615), 27: (19, 0, 2, -21, 17, 21, 77853)},
        'Q': {14: (10, 1, 0, -11, 10, 12, 78210), 22: (16, 2, 1, -17, 15, 19, 78330), 27: (20, 2, 1, -21, 18, 23, 78615)},
        'R': {14: (10, 0, 1, -11, 9, 11, 79029), 22: (16, 0, 1, -17, 15, 17, 79128), 27: (19, 0, 2, -21, 17, 21, 79383)},
        'S': {14: (9, 1, 0, -11, 10, 12, 79740), 22: (15, 1, 0, -17, 15, 18, 79860), 27: (18, 1, 0, -21, 18, 22, 80130)},
        'T': {14: (9, 0, 0, -11, 9, 11, 80526), 22: (14, 0, 0, -17, 14, 17, 80625), 27: (17, 0, 0, -21, 18, 21, 80863)},
        'U': {14: (10, 1, 1, -11, 9, 12, 81241), 22: (16, 1, 1, -17, 15, 18, 81349), 27: (20, 1, 1, -21, 18, 22, 81619)},
        'V': {14: (10, 0, 0, -11, 10, 11, 82015), 22: (16, 0, 0, -17, 16, 17, 82125), 27: (19, 0, 0, -21, 19, 21, 82397)},
        'W': {14: (12, 0, 0, -11, 12, 11, 82796), 22: (19, 0, 0, -17, 19, 17, 82928), 27: (23, 0, 1, -21, 22, 21, 83251)},
        'X': {14: (10, 0, 0, -11, 10, 11, 83713), 22: (15, 0, 0, -17, 16, 17, 83823), 27: (19, 0, 0, -21, 20, 21, 84095)},
        'Y': {14: (10, 0, 0, -11, 10, 11, 84515), 22: (15, 0, 0, -17, 16, 17, 84625), 27: (19, 0, 0, -21, 19, 21, 84897)},
        'Z': {14: (9, 0, 0, -11, 9, 11, 85296), 22: (14, 0, 0, -17, 15, 17, 85395), 27: (18, 0, 1, -21, 17, 21, 85650)},
        '[': {14: (5, 3, 0, -12, 6, 15, 86007), 22: (8, 4, 1, -19, 8, 23, 86097), 27: (10, 5, 1, -23, 9, 28, 86281)},
        '\\': {14: (7, 2, 0, -12, 8, 14, 86533), 22: (12, 2, 0, -19, 12, 21, 86645), 27: (14, 3, 0, -23, 15, 26, 86897)},
        ']': {14: (5, 3, 0, -12, 5, 15, 87287), 22: (8, 4, 0, -19, 8, 23, 87362), 27: (10, 5, 0, -23, 9, 28, 87546)},
        '^': {14: (6, 0, 0, -12, 6, 4, 87798), 22: (10, 0, 1, -18, 9, 5, 87822), 27: (13, 0, 1, -22, 11, 6, 87867)},
        '_': {14: (11, 1, 0, -1, 11, 2, 87933), 22: (17, 2, 1, -2, 16, 4, 87955), 27: (21, 2, 1, -2, 19, 4, 88019)},
        '`': {14: (5, 0, 0, -12, 5, 4, 88095), 22: (8, 0, 1, -18, 7, 4, 88115), 27: (11, 0, 1, -22, 9, 5, 88143)},
        'a': {14: (8, 1, 0, -8, 8, 9, 88188), 22: (13, 1, 0, -13, 13, 14, 88260), 27: (16, 1, 0, -16, 16, 17, 88442)},
        'b': {14: (9, 1, 0, -11, 9, 12, 88714), 22: (14, 1, 1, -17, 13, 18, 88822), 27: (17, 1, 1, -21, 16, 22, 89056)},
        'c': {14: (8, 1, 0, -8, 9, 9, 89408), 22: (13, 1, 0, -13, 13, 14, 89489), 27: (16, 1, 1, -16, 15, 17, 89671)},
        'd': {14: (9, 1, 0, -11, 9, 12, 89926), 22: (14, 1, 0, -17, 14, 18, 90034), 27: (17, 1, 1, -21, 16, 22, 90286)},
        'e': {14: (8, 1, 0, -8, 9, 9, 90638), 22: (13, 1, 0, -13, 13, 14, 90719), 27: (16, 1, 1, -16, 15, 17, 90901)},
        'f': {14: (6, 0, 0, -12, 7, 12, 91156), 22: (10, 0, 0, -18, 10, 18, 91240), 27: (12, 0, 0, -22, 13, 22, 91420)},
        'g': {14: (9, 4, 0, -8, 9, 12, 91706), 22: (14, 6, 1, -13, 13, 19, 91814), 27: (18, 7, 1, -16, 16, 23, 92061)},
        'h': {14: (9, 0, 0, -11, 9, 11, 92429), 22: (15, 0, 1, -17, 13, 17, 92528), 27: (18, 0, 1, -21, 16, 21, 92749)},
        'i': {14: (4, 0, 0, -11, 4, 11, 93085), 22: (6, 0, 1, -18, 5, 18, 93129), 27: (7, 0, 1, -22, 6, 22, 93219)},
        'j': {14: (4, 3, -1, -11, 5, 14, 93351), 22: (6, 5, -2, -18, 8, 23, 93421), 27: (8, 6, -2, -22, 9, 28, 93605)},
        'k': {14: (8, 0, 0, -11, 9, 11, 93857), 22: (13, 0, 1, -17, 13, 17, 93956), 27: (16, 0, 1, -21, 16, 21, 94177)},
        'l': {14: (4, 0, 0, -11, 4, 11, 94513), 22: (6, 0, 1, -17, 4, 17, 94557), 27: (7, 0, 1, -21, 6, 21, 94625)},
        'm': {14: (13, 0, 0, -8, 13, 8, 94751), 22: (21, 0, 1, -13, 20, 13, 94855), 27: (26, 0, 1, -16, 24, 16, 95115)},
        'n': {14: (9, 0, 0, -8, 9, 8, 95499), 22: (14, 0, 1, -13, 13, 13, 95571), 27: (18, 0, 1, -16, 16, 16, 95740)},
        'o': {14: (9, 1, 0, -8, 9, 9, 95996), 22: (14, 1, 0, -13, 14, 14, 96077), 27: (17, 1, 1, -16, 16, 17, 96273)},
        'p': {14: (9, 3, 0, -8, 9, 11, 96545), 22: (14, 5, 1, -13, 13, 18, 96644), 27: (17, 6, 1, -16, 16, 22, 96878)},
        'q': {14: (9, 3, 0, -8, 9, 11, 97230), 22: (14, 5, 0, -13, 14, 18, 97329), 27: (17, 6, 1, -16, 16, 22, 97581)},
        'r': {14: (6, 0, 0, -8, 7, 8, 97933), 22: (10, 0, 1, -13, 9, 13, 97989), 27: (12, 0, 1, -16, 12, 16, 98106)},
        's': {14: (8, 1, 0, -8, 8, 9, 98298), 22: (12, 1, 0, -13, 12, 14, 98370), 27: (15, 1, 1, -16, 14, 17, 98538)},
        't': {14: (6, 0, 0, -11, 7, 11, 98776), 22: (10, 0, 0, -17, 10, 17, 98853), 27: (12, 0, 0, -21, 13, 21, 99023)},
        'u': {14: (9, 1, 0, -8, 9, 9, 99296), 22: (14, 1, 1, -13, 13, 14, 99377), 27: (18, 1, 1, -16, 16, 17, 99559)},
        'v': {14: (8, 0, 0, -8, 9, 8, 99831), 22: (13, 0, 0, -13, 14, 13, 99903), 27: (16, 0, 0, -16, 17, 16, 100085)},
        'w': {14: (12, 0, 0, -8, 12, 8, 100357), 22: (19, 0, 0, -13, 19, 13, 100453), 27: (23, 0, 0, -16, 24, 16, 100700)},
        'x': {14: (8, 0, 0, -8, 9, 8, 101084), 22: (13, 0, 0, -13, 14, 13, 101156), 27: (16, 0, 0, -16, 17, 16, 101338)},
        'y': {14: (8, 3, 0, -8, 9, 11, 101610), 22: (13, 5, 0, -13, 14, 18, 101709), 27: (16, 6, 0, -16, 17, 22, 101961)},
        'z': {14: (8, 0, 0, -8, 8, 8, 102335), 22: (12, 0, 0, -13, 12, 13, 102399), 27: (15, 0, 1, -16, 14, 16, 102555)},
        '{': {14: (6, 3, 0, -12, 6, 15, 102779), 22: (9, 4, 0, -19, 10, 23, 102869), 27: (11, 5, 0, -23, 12, 28, 103099)},
        '|': {14: (3, 4, 0, -14, 3, 18, 103435), 22: (6, 5, 1, -22, 4, 27, 103489), 27: (7, 7, 1, -26, 5, 33, 103597)},
        '}': {14: (6, 3, 0, -12, 6, 15, 103762), 22: (9, 4, 0, -19, 10, 23, 103852), 27: (11, 5, 0, -23, 12, 28, 104082)},
        '~': {14: (8, 0, 0, -6, 8, 3, 104418), 22: (13, 0, 1, -9, 11, 4, 104442), 27: (16, 0, 1, -12, 14, 6, 104486)},
    },
}

_COVERAGE = (
    "eNrkvQV8VNfWN7xnMvGQhJCEkODuToIEaXAvUmihaHEv7q4tXrwUK+5e3CWUYIEQNARJIIEQl8nMnPWutfex4d7nfXqfK7/n"
    "/b7dMmevnZkjW9b6L9nr9Al+MUf/3+B6G/tm/eY2+nsWDOl/+V9F+MBYvjyswuqlrsMAyneTcgoy/5AAxq7BXcbuwNN/7oOf"
    "xb8Wnq9gpYLMLResPnkBoKDLR/js6bel7oxRBeCbq/scLPX3/cLW5u/99bDj04w7jzf6HU4bsqH/ItjCXkGbkbCQ3YSa38BI"
    "dhCC/KcWZQ3GGApOn1mPfTdzvKkXwEYWA1C4GcA8dgMk54oAw/CbScwHoDNbA1EMT1aPTYNzjB2J9mVNY6YwLJ2WM5cb/lT7"
    "5VdWyeLE2PKDcdEHr2cfHM4Gzcz8feaVxzPbMeYmlWfbltPXqlidWfgQxmrEfrDFxloSY0PytN1xq11P6NnOk7FNK1ntLCN9"
    "r2lpFvg1E8V3UFH8/LaxTI4C/H0BuCyT6wH/EAYbqO7p43MNKvr4jIFpPp6sqgRakcoWvX7rPqTdunUrHe7duhaIXw+GffgZ"
    "Y3USZ/oen505W1/IJ54NvRirACep7hYQcBDaBQT0go0BASYcGF35ma28ehWyr169mgj3rl7tjV/3hxv4eQEKizOFwjb8fJdt"
    "FGRXGMyYyXJJvo7Blz695Jug4vH4FfVpn4QlSksdAC887IPflJY+EE+HhzBWafkJzuOnQw60IWrJ/fv3P8Nn/HwI8PT+/cH4"
    "Vfuyg7WYMGEqwG8TJkw4BR/wswb9sBTOYTyshT+UE7cGHDTGzsMKpeVHeEmHtzBUaRFfd5egKVHlJ0+e/AT+xM+lAMsmT+7A"
    "Vn1x8TjWPeLOfYDoO3fuvId0/NxIP6wAUAQPG2G/cuIOwLvtCs5fuUzAyYjlA/RTWga9GkH9eDuisNLikFZD9OQAWFUWjx3T"
    "3p/6AOMYu4d9ZPhVKuJunY7NeX4IYOdSf8wnvrs+LfdYVz4M7t8dtt3ylwdP+rF5IvWIT9Y8zw9PO1fsdNQSzIofywDr7Wb8"
    "y9BEHsiJ+dUhXHCnqDae2HWhar3e+Dj4tbqoFzojeuNlTaK2Q8aJSUMOJENyLcYCzEAziRX8TDNwMsSa5DmaZmQjIN1FnMAN"
    "B6YqwOki2rUm2MB8vEcehWx7BVdB5q5WJpkuMSMKL3itgPr9CuusEO+q/b4FQFPjirWBMvkeprBosboYqw/Qks0Eabk3Y96t"
    "bkGmK3PcjKd798gGkNSQ+qDvsXRseLGhtPx7p5vQVtcT56CujqrWxVlHMV9PPcUaSdleeroDQJBGGUovBujooAz4yETek4kb"
    "qhHpfFWdael0W/jVV/Naelf68RxARi3mbIbPYq4YcAQ2sxoAh+UTFUqBjwachleV61Tu3IgZPoKtlv5WfgewLNBGm7nuxStZ"
    "z/bLqzQYx72ii+cc6KCsa2OjzanUlNBU/ZVL++3YWdbxuhMX2CaBlF9/qf0A3cbuXmBQ6O8Blu8E6KDQRwC+x56JqSpIZHo2"
    "f5cbeOk1A+vX7rg0BeB3vL9D2tJbROvJ4dst8UTEbFRHxzAYIPi/7m8crZcP3JSRGtyFZmDAaAdj7KZzu5CdXdrM6j5n+XNc"
    "2IKHbqzZPeYGnq1Sce25v28++nLhT9/Rz776fUWlm2udgh35SZbdqfXh9vsytDyTSyxbwBb/hNMzuQPbP5SN2MNc7i5lbPoG"
    "tnkCm3YFf1Dg3KfTvsqt8E4NmdFA7hXXEc2Z91OQ4JW44a3IlIfADN8RMJXIfnDTkd1IxLny8jnJoKxPOPivH2H1UhYKjWe2"
    "VliNpj/d/sTYXphPP5pnK80KZa9jw+ASXzuFLEknE6QKtcwf5LVTcNSx8UXzvrKGMa96yjQ0HIFpQfuyIW62oMfBaeMcWNP1"
    "GlThvMTy1s/49gFjJWEVkn7vcusxL9iN1UwUZ8bTxMy9YA/S2SgdpsMRfD5D1CMjKwtzWGPrKz69hsGB8Y8sQezi55qCb02N"
    "tp7uZLdyxDpyrtYhxF1tK0QcMeQ5jvmHVnJTQzOx63DI2PMR3gkGkT+eLloR3vsw19vQji+tcxCDF54PK5EYzUUmmwU5tB42"
    "wyT87ALX8bOZDREDlt+AkMF3cIWxoET+LCSy1+PnFFjNTFfhqbi7vBkpVVmRt1I5FFxZVVQxAu8lZHjtJPhBnZd1lkX92sRU"
    "9DNsRclaOY/2mE5/wiP3+k9QuJ9QJ+ovkF7O8QPk3JZgl9z0DUB3nMwR/qxiVo6YQqVSYR1jh2E41g8iJqI5dB/uuhDmasdl"
    "KUcrv0JKCaa0/czlX0+QOtKfDsEA/NwFKHkqZMAyftZWcNuZFU/JzIsSHG6KhW+MgaQb2cRAw6zPFflUYtZz6dogO+ZGD+on"
    "j97glT/wHzvdeb35/VHOCqEca8xXY1WcSX3M7nyuRc3NGcR/MRAkXMZtG7Lx5qnR4d4sbqKreTrL//D211J5f7pf33s2nGW3"
    "ImsHdY+33Pdl/n/kwMclhW5H0FUClBvw/37tmh7qGqvwjhjEq1Iyg30Pp9u2Ow3RCiBJ90HYmwklONkRrtHhCdQWJ5LMZYh/"
    "pJgUjBaZf6rF+p3C9yIgB5K7KhcqeRu5dHGqTVluZA3T4UE8/IESqSxkGYt8gnUupd/CWTec9xcQeMQhKygeCxc87sFAZMO/"
    "0M+KvIDnJMPG0qTDEhQHJDwrgW0cLiBvklA3sbOnSvDmeIQZsqY+A+wk1vlWNk63g4g0I2k2MOZYyY7zMrdGP7b20TeYNuYS"
    "lDzuobHwo0g/tgA/oSidAQ4VZ/6IfAYpTb+CjbrRLQkOKU0X4DE/noY7StMcQM0BOy8HFitNtSU4YmSFH4NZ48wLUQCMTgXr"
    "N7r7usgxVSvdrRZHEQAPxE0NXF4BP9uj+MkE6UdqKQcEoutkQ9bAoi+BgBF2LzRghjdgQ2xS8BnAZMZOQrIjKw1wnEumxwDT"
    "K9hoEXwL0EOMcyTAa8gpyk8og9V8d/HCnP29hjdiwpcOB/nPeO+Jfcv7NZ2TCWAWbYZZCkzPnVUAf7uMeHqXc5+xX2P2o1Dz"
    "uQq2amJ9lKinWzKo+qDig2oPKj2o8qC6g6oOqjmo4qB6Q6oNaTWk0JAuQ2oM12BIeUGeibc8P/cA+9raycS278CWeOwPg60F"
    "rj6ojzMIkLf6QR1kohBG7Jj4a/hc0goeI5MIfHsDF1WZRdMFZ8U5Ypj7HGUOmwHwrC0CF8tX2L4c6AeInirTlyDDgSMo0gxY"
    "G6FWdBM4dzDXDxDYrhfMkoP8voJ/dYIjXB+Cs3SoCc85Z8+U+Lw8gXAMy0i4S/zC9yUc64R3Vw77bgEJqD6bv+X9Vn4IKQnV"
    "cFWguAvCZZ21kRnvgq0ninOEPovoS5MgjWOxi3CRg1qzaMbR70LHWgD0SMiEIEQseKhEx94gOMBIAI4Yh6JmSsceABwBtgOo"
    "KhiYAH7VQKDlEkDaFS65NBQKVA7Dn/w4BMycDZYEea0gslpVGyGL602cIrRW/A8modrNeWvlhn60YodLZ/Cxq8YTzx70htHK"
    "L4mrjQbSYCN8k/49fuTggjGRwPMHlF3Nc3ERb73MquzLbcI6rKebKiNAtcmafZ5Wm2F3JnzgKB7RU7iAPR8lgYv3QE9+HEMy"
    "iZH+KThPNYgUMx7e8GMgpPKjN0hc+fMDM6eLQoLgsfCMH4Plp+8Kp/lxsVhBqPw3oMPXkI5sr9SEj4RnTLhwtuIiMe6a04SA"
    "lMP83kLXKIwdFEX353wGGdIdLvp9ZgPHF/g4f4BFSN6yIAQ7MyQJ/snYKYWvz4VsUcEBFd3xA4AQELjqywqVQp4D7CuA5rzS"
    "BEBo518DCMWrO9AQYBkA4CvrjCBg31LIEJe4CrdEh2eKhcIaADTi/R0FGTihnZoe5pzEMwEfbLeBViXE/cbvqlUpFaR+cGKO"
    "h8bEjpzmu/cV3JjNgpNuXPBgrfaXuEAKXMGKsgiK4fM4X0vshkqFGuFCvXY8d25mktP8T8R6zE/xGXvbpOuELvrZEhZBuCfd"
    "6VTfzDjiYS08WENZOrv6qpp6gmqEYFFwgEvJmyvy/Q6Tiu3ZRjM++RacywZbYMM3VsHgnuNaMY1CbN6eA8YBVtgHaaQPBEvw"
    "p/snMOOqdv4NOrOZ1skCKOD3Fd1upCKcMr7SVxyDgoIyvwkKytNdZqPbDR4eHpmtPDwc//bLfM5qul+pTk52Sk0jHbWDM77/"
    "hnJwwrILmtHB4JiuU/CXOZy5heUTRNNhyD9wzr9DbaWlrBb/Wg46yqFzezuhjepwYT1dU+ZQ/zz9yxMqsaiu88r0CHuTxvFa"
    "vanMBBjPKxX+1deXsWNulq/dAzurY7hjgZs0uEqGt8mPFT5/o3ovyPVfgPPyILRiy3djn1UfNDAvw/sP9kIxZQgGmIh82lIA"
    "gTmCevdyeB4/nEyBhix6nGoFS5QoUdzIHJ14MXaRH/NIm09JvGwxXn4ilxOuai/ksnGL5TL0zJKscw2vX6uG0KJbN8nWnHUc"
    "1Mc9D36pE1kwu7p8BLMY1+4rOTt/NoYOzbO4bDvKpWBRK+cnC29ysPWRw46eiVxS3VrAu8fK18dmLiXzZXGLzNinXC8sXtyu"
    "n/JObMlU055iWXN6Lyms5Fs4pfz9iswgUfuHV8pkW4fdJYpXRrafsiiF6CZm+kTmiiSsbytnOgR95Fph6yfFyjKPoIIYuwSb"
    "cpPd4YTyoxugILlq8FI2GrKNqqUvb2ZWPsU0Z17O/qYU2rVLA6hsBSRp1h2PFA1bktpg002tSIFJVEtPa43aDTFGzUSRy/Gi"
    "XKZDdj4Nh76DzdqfEAjrjCYXZW4v5J4kxL8oq+Gji0rkSRPIQ5ShYC2mKUhRcEz7E0qfFhq1D55rtxhkgdHan2ZBZl5NZ4yH"
    "jdqfUKZV06grApwxRUp21yj3gT31TIcVGLpqAsG6ah+kqwAILy7Glcch+pTHXfqVucQMgmYV8Oc91gTCkJo4mcIresKP1eHr"
    "mpdQvx9VEMZt6oKQqofh890XjtiF1RD7Q4M5yQgiHLeieDjCp5ch0FFe8r2W7ZjUQizzQTl8md0sLGT0zTHdVwLEezCPRDji"
    "yB8Ip2lvMXpXz12CWMTcOe40kTtOAslzPxnw2fo3puo4OGdp8npnTGUBAGGXaOhGmvMjRoGmF2ELMzzdSVgJmvyBSLQpQmfE"
    "sNBoA7xgh++J0S01BuW+tT+fnGZTbYDUZLyS4R2JxXMcrLms43ivMuKRD5GIW9Zw/r3vI4DlUQ+1Lytro8/yhA7rV1Oli1/n"
    "yoFln1BkWiOyBRs1vaDOz4cazZkGHj4IRiHSSFo77CVxP4h+04U5ZoKVg5DIDOyW62TZviJgxnrDB0gztAIxFXajSn0NpcZg"
    "gGl8fl8lWyw0GiMUoxnwLT0gNJ8INKsc4947kUYLLQX9DYdqG5BGhDOesUuWgtwKAs36EXqpKCD+HoDQRmSKWyMEG6q8AQUA"
    "IjzTo4hXOaZACmOIzLcKkzoO4HnSBLAQZiseg6dD6PEe6ZENm038JNsnK8UqbPe8wGie65/bkAdHTtMmq3twFVVAuAznvoGi"
    "Edzc2TTp7nM6Dl/vckM2f/6lY4W2baPD27bNt01cWugHE75XFunoXHoWPpb78M+iXiEack7K9dfwqlYPud5ltw9T6kJv+PfV"
    "HREX9YdU/HRBpUwVWIGP1Hq2bPUuFqIzqJsWSfBZpfKTqp2jGvPjQEeOykWl5Z1CIvK1jDU8U8hiSfGI5VWSFSe2qZG8/G8j"
    "C86cgyUJrHQYbRhmh3dKdLLpqBR8HM+hq0aSp6TAy88nk7KROW9IKsKcHt5n7A/y3izIFRzaeE0oSYaVEp+Oxk0St5QYt0hD"
    "5OMIWeT90RaLh3OuuEY90qB6L9s+ohZnjK0+8NYbuEKqW+DR1P5nrHDDGaXnHS+hgTT0lsTsdE2BKcXvXRbW69uaH8snB/oq"
    "0/YQfJJxlQMuZllqO+0TPIGqh+2qs7TqPK0qSy4TVtd68OI0SOujxKFa/b1Yr6FD+5RRTPsev3Fm93EnN3EWJVMt7+Grebid"
    "CO608ykz5xWQpw31rIccJRWTwOpF3rXeighDlewaZMjWqLGAqKF8i4qaefVrbZh94kDS5rkB73mbNuk3AXxWrWEuh5C311Gd"
    "Hae/pNLq6qn0+noqs6GeygrTU9mqL8RwBB/0yhy5fFfMbqZ99tdrFnCfdZ5CZSBjq+7evRsp666GLcniOX/OEZccZxMmMhcb"
    "fDzOrRGFS3WNSMqjgLRWxW7X4Tp3Y8cXz9pV6Pc8zokVP2qBzFPchOFYkDPRQRPlMqEI89Bu4kdmmLGElzjIqq48xgiwqh3c"
    "zaYZAFvkwhzVppcBm5QhL/oJUroXUxEglXcNhMXgu24Dfo8Ds2bYNz7ldna5DINcj6/6F2Sy4RmKH4TL4qxn4BnrCfAzToHS"
    "EyRYyoVV1uMXeO4D+OyGdrdRGmffHiPfg2PJio6KpAhRSyX86zJ9p9cl07quoKqYr6koze4DHNaho59R2OociuMAojWIyPpI"
    "EKfzjbazQGoVHe7MAnNjjSyYDPBodH3Vi9FeXNyyTr7lAmt/++1MJsm/vDqFqOElgJ/0DC1fmobIZdOD1bvwgJ6OmoMWio1Q"
    "1zdz/gyPWSXsNeHFNG3m59uC3ba6fa3vdyEKSa4sFrxcIoWx46uLpDpl3vxZvWFDUP1yuq4x9J4grolcgWO8spkneMXpzr6u"
    "vLLonQ+vfGVtyqiS980yxisz4c7160/hwZoGM7AcgJ+6y5NGVkU6WVULNGs5cYR20T54SyqGLpmmo0zhsEOjZsP94ipVz5pd"
    "IUihPGNgJFOpbXDaoFLfwqdAplCFk6EzUyjjJaELCAqxTyopjTieueZDjfQz6Tzz8uGlGoJxHxWrFNPd9ZeUf7aqgAmNKCQk"
    "j55ui/ziNz1a/wiKGUwMw2mw2jUg0pqnb6iUDWfy6xpcHsKnIH9dw3IKi9E1NJcQMesa/OIhxlPfcASs9ZiuYSAIo5fSUCYD"
    "bjvqGgy3AEY0p4KK9/VvvqlZ5IsIivgAyb4hlhWrJJemKCQq6Z0Zheye9i81eKUIaeY1iXgtjmtDiERu+wvNRnl1j0pWXBJx"
    "i05sJbfYFjg8aZ+E2nwRsn5MgzLMKLTozp6W0dwtWIYdT+lVttunCOQ3vydD2j5u0jcIXmsaKfPaH1HDr6I+WVWKSvgsuO0C"
    "d5rRN7X7nAwHNWKl0DAUlXBGm0krR4cZxIrPEmiB9L0XYNvWtfOSz5AYxFivaVx6lX+rOWfo1pMNWiACKgeDzghMwn6AVNNg"
    "yOE2JsMxOMoCEHXg8vdC9jAAOVQGWJ48tIHEPc+1jicAZFzuppypSGUlDsOxpsprCxE9XhvIBOEyU8snMX8yZHbblCAW+1N4"
    "AtTyRrZAKzM8F/bqaVTqCPWoz4TMbdWyW0lZd38XHrtmWqDULh/u5gR4MqbdsJ0ZAEfxV6E3r0/i07Mmgq4R+jOjGn5DTzum"
    "QaZJ33AToFD127cVK51TJsQZikjwWlbyGnLY8ScuB35z5d5wz0BXXJ/nu1ZruxBVnes0RdpkKDe4X8y+6lujER2lnBunqf1e"
    "jcprBAuYKMCNw8WXgjlMsYhnrW0RfhvPl5AbuyEfWds3dxj58aGzcypqvKwu9CjMnbvGrPmGxLXcSt+FzbJNq9rmWTTy2Ckv"
    "IPWYUBR8NS5bfPz3mvv9pRpOQpbMD/6aJiKpNqgSaRoOdbwFkarOuwDFTG7UDm6LDSUAiOtcWm1khgiwzazoHLKVwEcDGfEZ"
    "VkKmz0+KoxU13Ka/cw2fSiIMHwPvxZAXkKBBDZDNqCMhy9nhNqS2dmDOQ6zkA/BGbpP+IAdgM3Wg18/huZB+ZozSmW4V7QYU"
    "gUIlu7CdWLAFMDsgqZe+QxC56szMFbIgs6xGukTyZcM0/71+GbK2EtgWjm2pnL5AojwJIoTZ5ijVbWZS48YKPwScaOblEvor"
    "toYydhY1fHHr4yV4Zgq04YPLZ3oAUKU5wBnlQosB+nYExR9C7jeYTAq6QiMebohao02WO6a3dCq82bv81lwRvp5EBH8Z2fCc"
    "1l9NvAMQRezX/aIya6PFI7iNOoALKPn4eB1zLl1Vnkbfclg7zmFLFJYkSagr98/KvhFhktwvDIKFLcLAtSCdS33XT4Lv/SCV"
    "Ez8SbqQqNm4hMwxXMOzE2gEaX9ntuGy9KNnac9cG1YzJdspuL+p4s2YNmwXxyng6f4AZ2uQ2q7PgTwo6Uk9YSzvhTd0Jv9NO"
    "GOeonXCadsIctZe28+gTWlsaRg2p5bxJLwCn/a6n5hfppJQbir9aWE/hk4ZOUUFaqLkSXoFF8x2gjrVfH8InXHG8VJTgnvYn"
    "ZNV99af/aHf6+XanL6Q//V6704fqT3/X7vS99adPdNGffq72xT0Qr7l2ig1bNZG8mGEpT7fesI1i7NQ1HLSfkk0siqZKV8mX"
    "zUrrV7b9y4u43smuJCFzvP26Q8F6lz8HleVqor91YFWlYnrwul2B2pfSg1jh/RbIucGdG6aC8rBV6LN85+TWnMsa5whY8qwi"
    "N5lLm78LG/UC0ksy02dh2vKMRJW0NrdJcul9lvyWAtttIEnwFE4Qlv82g1yslRLg87ndT3AZ46x3PiZG1toMGdYVsGzo23ri"
    "XcjtwQZAKhfhTpshwbhfmXooY2o95MFIdKtp8N1WRVCFgc2/lQTbyEreKJ4m+XzSiI6/BrhHd9L0KmpIuQ9XyNFujsUr68IU"
    "veoP6x+sjnCdaP641qtCpRlKrCiR4vw+kUc5BFWVqQWZoeQG1CXwgWeCMulnch/sLUiRz1xUohChcPgkc9pCNgoGWAgimJfM"
    "7IAgItgMWQPwPAVWS5BIUqU1smzbczJCJVbmis4DZfqfoBOXeoaw+8KSVTcQ+1z2IScoHBRmA+T3R1h5UF0eTq8h0/VH3URe"
    "AdBiheLWFe7bfj0AlmvmfKlQcRt8lr/Q1woPCDWBdXnroOKdduJt9UPGs1XT4YVLI/gEwTDzg60lVXERWE8zUBYauXos+WOa"
    "piT8EZfVhZne3PBgzieTvctx9tMUmhTj0qI9NDBEPCvOAu/GO7MyD6V3Nv53pzoTbCLqy3g2VqhDY61C5gXlKIyq7IC1W8cK"
    "Z6jTXItw3QVyaxNcmjR4twWeu7J6Eiwiwdk2CxagHvxWCeN5jiJFePwRyto8DorgDIrgyHWcASluslC6x4JS4DLif8NPAP2R"
    "k1kg8+JhlF2R9KTB9/icMctWg7yNJ4PmUXF/CudUELMRtQ6dN6Wj2k1JSkQuxwt33PXSuOno7yurHVrjPn9A8yLBNCbmKuPx"
    "iFTbMLyRra28yg9+B3DTyJxwoYleKooTZygFfdxXNErsHNIkFb+ZhxkBMt73QOVCr0By+1qzIBUE7LSiqKW4K34cgumobV7n"
    "w/JtLolT5otd8nbTgJnnEOZwiVX6pnJ/aWJBOQza+1IiBV/nLnJaZa+rtEEw6a3DfYlgbaCDI6fsmCQbDRDuqHMX50BaSd2f"
    "F0CGKpc+XTgpS53DS9KvtsvMbDMAwUrolSt12d8pwadP16S/d5akjqz72FE+Lti7P5BndIBDxLvYhuz/Xr767ht3Z0S9vfkv"
    "TB/A0oqd+8hWnNC+MnMfe7LOZAlmBViej1nLUZQfdD19ddTfPd3mGxTz1K0eJLv2g7Xs2/OIuaqMHRuMMhhZ7h6AC2zyu3c/"
    "/Tc3lfeHQbVQPCNSPUzBwU/hEXO2wBhWAtKR/ZSWDaaO06i/y97+XJkZRmT9EcTyn00faCAbFRe7bhusizibax3/kMO2fHtz"
    "6wnAozrfmsiy0G2llMUrtaLBTHqGaYYF7hNvK/snWOfRvB6QCU9ry3Nso1hxeRIhRu7fopfAtlSwZ+OYbHgsY48Kd8AyWwy7"
    "4xyLiHEiBv3UrAb7tVOfulNkGYXZb1PFfhhKh1jOPF2X4XTdwQ1ONaIAPnbmAmYaTukjHK8UC0e9pLcSFwLnFEjxESyqjjAA"
    "v71fsWHQWT4o+pHLUjz7FiXQrVEswOsmil6BcEdarugc7RN0UM3voD6wvprpaRqV/tVCqSjWt3I1qXi/zqUyqO6HRLmsaPA5"
    "RS5r2X9bnF3lYmyiWiB21LwfKZfZTQaopU+eZB0i63HqtVpe1mX/g5K/slrKGd7rTt35jY5o7x6oFn/2O4dcl5JpKjpMyDlA"
    "nV7p7gcKFAj6cA1xWMLdcl5bLHOc2Isn1J2T+ZRqvl4ZgcHwWpZxfijzVooJZxyVBU/kzi97C+jXfBJMNcNd2bhZ7bUcgOy2"
    "QgKucIY8gcwRuCyc5lkgnGZY5fuQO5UEfmgOiJXBhtl+luFdIRU1O0eP0GwR3qgXqxjVgPpGisoZTdPJ/6Qqm9UfASSo2wRc"
    "fsJptVWNnwx9AfCmnhoWsFaCDDVmoAnq3DLwdl8lgSRzz7ooE941E3e0EBnVdmFyrRqpLAEECQh/jspKgIcNUtUY7jzSRZ3N"
    "t4pRP6gtFy7rgZ2wVbp12nLV1JJQ4nfQ+jvyZlcTe0eczr7iAc/7UqoJk6dYqr+/ke3mcnTR+EniePuBvFz6LNkzvzvnBZ34"
    "Zgd4jhi7oRUez/tmXhok5EN+9px4QjlkaUEAwlsQAb8EbFrMO9wpUZNvsyFd2RIzSAPk3WyKI4gVSYXtypdnQKq7tuNlD9MC"
    "OxZoFpnympowaq46FA6ghVAYknSKdIGmo/qHKtHIJU4IW82vvKENx1Tcq4QKQNEkFMPt3Xw7v+cKzBYF5AVmAPiQ6auqEoEM"
    "tRwzFDiD9ykFMuc88kwra4OHOk9RtOzmFYOJQnqTJo2vINjU9Pu5qBK7afZ7iyLIeekJ6uWorAFNBxSKjl5IBrQO088T5/x2"
    "odgRIDXVkbF20RrsKuSqsWydj7+Mv7aSBs+wK2ZocPku6zKQoQ6KDmRubkbjkDhPdq8vm5KQcW+O4X0LH4tP4Idypd4tZDsn"
    "lUlmP2AH7ljIli4qncK64jgeXMHWzvTILpM3+au2SS87xrZkJ35jX19/+f38q1Nx2prLC28PObmGWW9Paj/41HvuKKs1bte5"
    "zQOUOVG645Rf5/3wleqyKLhb5lypgvmwFunSrmG1Pcp3mR0BbwgBBiRYFWTuvAfOGMgeSNPVv5ID82DGbfADy2t9jIAKwU7S"
    "QuyKOrCPdaTIhNPwYv5bgMHMlByDoL4qqw4nTcz5Fu1BPAzeu8ALYR3FhC+ilvVQ7AC4sqk8EvB7alkDRfeAB6pYHbnW8iPZ"
    "//Pj11hDPk9PwSFmjH7LvkGAZoiQVnS7BDnWfadhDfPI3oHTiHzreyrcknIOIls7moss0ymkEymP3iKO0xKjMrO6e7hJo3Vm"
    "1twyOJ/cQzZZ04VQrI0w0foaRYn0R2WF11XqvfLS0VXjStsLCKeygQb7FtOwI08R5GdFHRuvTcsGkbR4XsWSW/FtH1mgTpTg"
    "/tTmJCt9v7+IOgE/UV0LnFKXsgnVONox4hUDu/WBkzMgqzzFAr+nM3XddH5hxYbLS9O2EdSW/qD4ZhMPlUh7TDB/IVxlThkU"
    "TY1w+nqnge85+G8MGQ6hkOBAtukZIhQWW12yoFxX2lqRV8TVOmVzReE11O9JeLkaZJiEhXUc99p/1Ztaa8vqylneGgOh3RC6"
    "swJgIwxmSOb2jhSo1JI2ICBJcrEMD9apDCkOebJp99lMSOzqNxQBj/T7D/dJxzlG2qeXUC4vL6bP14XIRkY7A9wWR2Y+/MmN"
    "NVm+cxQNpp9V45q6slbn+2Ws8JEoHkFtQM17v4y/A2ckQ5ysFA1DaZV4Y9uuKy9x8K6qSlDTX25kiqiNPaF2Z3eo2KN7/SI6"
    "XG8YNlyeCfVUtrIx8sEWIdbSfhyVwYOhe+f6+Zn5RtLLqJ8cIAdrSdpL04ZinefBvl279sEi5vA2YhOWiHgUT8EiKLPtRtkC"
    "FLFFFrcTx/jrDfAoLdczfUCdpOiHAp/DjnidVSpPOjRaiJhcMz++NJQFSY1gvEZmsetyVDhyEMlWhLH+8NqoaC1kJfTMFNtv"
    "mSkOuglXnYAgrVELELb6bM509kPSeSoX+DYQ5mfWwFME94bFhYnyPdDmhQea2LoDyygitawWn/fRaYwctM4VhkRbDdXXGFLN"
    "wX4OkN9vmX3THoodcdO3+OSQq+Z7fdMw1EbNut7BcheSXPaBVMwu8HcVecJn6WMfcdk4xKndhNzzE9kpyMauSo9vAEiFKiPB"
    "TqXpD3kTwjW5v5BFW0WAN4XDD1EcT7JxJk+GbCY2PIcEbxH2sYt3HF/H+qBoMfL68tGJnyB2kFKOA3Til1ENq7RH4zjdjE0n"
    "Su+DNRBv+byuS0YATPxGyvla7/iOgx3tp0yZMqkTyr+Tn8+evZqT3oidpLB1j1fXRYXt+MBOXnV19fkmczM7yW/qQ1528nb5"
    "8lXGJO2WvzPH7CUqCyxeJ+8GB9ebkXyIHSQu+mytK+stjMu9KtB4q5MprTMRm0aOHDnmQCpYOiEhcKJTDHIkhUCFPNtZJWZA"
    "poNCeMXhxDLDTrz/GWfNkFhSOzXZBs2wjnSMX5PA/K126gPwzqCerT6Ov0rktUJXlaD9KjJReEwc3MITJL/HghrNo/xMoEVI"
    "OjEVl7RzLdncLPf+JG3s/iDn01z9cG4zET2gKJZSvfemkuY8Vwu66YQIWk87vAIoqaMparK2ji4tgdVNpQ3VD5PhA+lLv2PZ"
    "TfvzIvPaXT+zBL+fG/upxJBTuKx2PUMIyq9Yg+78xpfYQfrrjweYqadxbfyqpxFedNdoQxhy6UCkf+6Cpesi2vI8374/5iDS"
    "UrTE1DOzhCbr1mLWsgFksXG/Bs+umT+gLrjehmq2T/wbE4vluvn3UNEPhGXDkRUiG5psVlJqLjncFBkwNYBdi3fguxcCWCfr"
    "0Y6hcyTiyN3uWODzHAGx3RVF21C2z4ZN49sIG2vRGDl2gxT8IOyJR5PHHk8BayMSqM85SPb/DHF5fGzQUjVitWoH2bKJ1uE+"
    "jFsID1QJ5GpYp+0a59ZCPbXBjloj9kuqQeTv1ACXKdWqA8gKe9EsGOaQpkRsHyJH+EywbGtuYmVwEpJasYQWK83W26TZGYYc"
    "/gBgeTJAZbvFyzjqIXTtkT/UU0NxjNOvZ/MO+FMosoYN6qjZ1hpFjEPyj5Vcyw/Zi/x4At/zpTgYmuVAblXC7111fruZ7CGk"
    "q/ALH+NcPknzIKF2+HOPMNAcQwLp6lUJOZTpv2lo/mVD6JehC2652rAw45Yzs1k45KiArTGZvn/WmVx3UNzuVzZIl20SQyRI"
    "Q7kyWALblh61v1v/FECI01FqB6XKLvDWy28hT7K93qjzf7rUruyqDOaUKf1qIOw6mX73bhq8Ls6ZqXPLly9krjoDiolKVegk"
    "KgWhp6gUhh6iUh8aiMosW56Tkc2adVthW8s5b9KlaUaZ83Yvz0dcYY+ZV0sScWzJkqXbb1jhbUmVPVZ/DG8dVSZYV9KxR1SG"
    "B2nEUdikEb/BSY1YD6c1YgOc0ojtcEQj7sB8lTBlQ0eVwJlbWBCBzZbSyGlMfY9J5rwJ55b1MqmcN7iUYrbQWG/SprqytqkW"
    "c3vRMKNp06Yt+s27J1o0buUwVAJzaT37pSjvfnYN5QE22DWYcuGeXQN2k8XJruE2gJddA6rHPnYN4V82RAB42jW8gyyTviEf"
    "BVXoG74CWGknOfaQDNQajIgqMotRw+axY8eOX3sVtaXMr+w7iGiVG6fFXJlaWpmkCBA8T6bexRJR6KQM5v7maE7Aco6dvN8Z"
    "S4O//XtEMyxNPQ6K8zfurfqc2+mG+AnWD4hIniV9sa7t4Phr9emteWnhojvn11i/vJuXnSX/B+fU19WYG1O85rpyVCEAFZ9J"
    "egH3h524O4vUWCVOp2nBufKuWdU08j+llirosIu9eC2ElE0pSd7/suvZU2vHKqWT3dUtg/QhaK/ETJrgdDKD4hcivU/K4PRv"
    "jomHscxhJ+M2YhnH/qvvHZRdH9pMaqQN0BkznJKjF7qZ1e1a7B+rZgqj98cK2nlrm6FPEC/52f/wvPE2NQBaP3GC3e0mzi92"
    "XbkeqblqwAJhqpZ2Q/CvoXJz5PLCZHd1d6T2LZLLKPZvurqOGiSZq9v5FJrNWD6A7Htu5+D5uZSPYYytpl70/fOTG4vhil+F"
    "pQXycUMVN4aSaWoczqJaAVTrPHsFdHfJ4epVMDRml98TRpua6846Wg53rjnFSm7Lb+5apCdTZYSg2N4MpXqu2TK+jQAH+WXv"
    "+RPSDQOjERFOH7whESTUxy7Bc27bC/wT0gp4WpSUT2XMMLAN5CjhUSHtAhfIO8AVVKTb9MZWC2oFn3QrV2mUGY6v0L65GY6P"
    "hDhtU9rSqioidMqGDkbVKjwAJIoLtv7W3JF5j5O4vWEeCcdnuC5XcyQ28BgiwoSjQ1VYVtRuU6RjzaH96+lCp4dfEVGS9xXr"
    "6XwQAWj4sc1RjpNKGV/FLajtOrqG8AzHy+inXQ7QzkUEpeqW3Pkc8N3T4UKPjTtGMl+bHhjKqtquvzEW7LRvaay07FZmsdoS"
    "Ls9kD/VXFUgnQY3Eo7ZdHE8UWJ3dzDrjdh4rBdtcA7OKlJvwWMl5oM42to6ifVl9CTIERDQgcEkhpWKgBNKuXnVaTb+EvS7S"
    "8fRXd8UkKHHtLVb9iQzm08nppfRTPriU0iftOTRymlBKAL0A6PV/q9jo0c1YedILy4j/65cPcuGcz9q193hFB6o6MUxDab8Q"
    "H/2niTU/iHKeCNCz6AdnRHnzL7mOjoi3KZEpM2GXc62qmtU3X0gpwonN1IaTYPWwA1s4Vr7/sYZ985TyWjTYlb/b0MNXKdf/"
    "k3dq34AcWt3ig7p1kmv7rifDv/zv4KXe4ylR3V//P15q61yrunEyAEGJXv+Kf4MkSxPWn2OPyQXYsQdYnst5KVjIX6sU7mjk"
    "1pla7XnA05Zsp7zxz9rWWpWFDK7yJQnilnEDopvQfj3HqoCkLwWTacWB+S/7RZRTRKml63+GCqnroIZoMjebop3fo9ibB3JC"
    "x0IS7VKlJH6opRa8Ap9QV3Q4gdjg8QsJkrnx1nkQbRZ6tV31QHtVVizwBXRAOKQQi7QzZbLHejKblW+jlhQlr4gSmvy/gkyC"
    "9NajVBe5hwQ3H4BN2RJXDWAZMv6paiwWdP0e4J3wnra2gLmg4wWAnJ+71Oq6zkbmTeajptgUqa5MPSnXou3huuZqdFf5hrK0"
    "bU/+tKAJlQnsFn8V4YPHcu/CvRH8Vk245olc69XnSx6ce332FqA596AjB8cdzAccOUhul7PfkYPlVtl7TRwsN09d1nuccJP6"
    "jxznLWPSoi/gia+ol34DUQECq1Z8D5H+ArfW+AR3fQWGrZcCf+YVeHZFBs+aJatFV/OoKpKljE5deh6k1Benw7MgBQvXS4Wn"
    "gQourp0CTwooGLnWZx4LLe6nehI8DlCwc9WPEJVfAc+VXsAW51pVFL7uFVzNMEmLxUkFW3kVUbbKAmsvFWB2MoOlm4o3e1gg"
    "t4sKPwfawNxBRaOjJchpo4LTaQBZLVSsehXV5SYadJXTSGrkRGZHZrfQkY+Qbq6RrXHmZDfTULARJ1VWUw0UG1Yh3UTDyIbl"
    "eO0wHWRerKryLZUNApmNdIB6DkBGQx2inpgGl9vL2cFOXvsnj49pB24ro9Dqrb69x/trGk+3/13VvsL14uGggZDdmha/w7lW"
    "NaN+25ASWiv3fNf/j1MHlM21s6vagY7f7JT4Ge3kDh3U4KSVB3k3hdUn+RYrw59Yi7UFM9YxK2H1yRP7zzKHqMVRWKtgC+uZ"
    "5kc1tv1WzFzGa6UsyXlFjXXB1SBqHIGvPiDv2Lq7pOc4LWK9/sRaZi0k3usTbDODVF3dIkCkkqHEL42TkryfZSnWkDwiTOyF"
    "snNOEdnqLU+j8iusWk9k2EC4a2ClLVkFBOn4ErqwXbCYCZL1gic1bGl+CunwBD5Q3KhMknzF51FJ4y2ejkUhmdGV6UnFVPol"
    "+c6qekdRNVripDE4btSrXsNhIje1q2URQE8crs+ajhaEGtqQuaDfWIAMRTRlKGbokrlKk7Jvgmydouk+T9hHLNaGdd7UJVsO"
    "OjoCn/qKprrLwVpObN+Y0EluCsjg2T8vwAd3pYktBKkGzhEYydSmfKlwCifLWxeticZvGY8W1pq8kijzsaO+iRt4ezG7Jo83"
    "8MDBvom5l3ZhXzRpHra/2NRfytYHj4TmWtsJpll0gtNJazB3fuU/CQ+dRCU6e4aonJhgrigqpj/DHXiFVTKPFhU2PXOiqDje"
    "TxcVyk2Q/yB3Hs+x+vQeo0Qx9RiL8lnxW6RDC7OqNQsizlsjrPCrRiwGKUwlwrbCCzeV8HnPA7QFwTqANUQl2B56FIXw/wgz"
    "VYJ9B+aKKsEOw61MlQikjCsKwbcSqwQ5A1vEW+QJXfijtbZzrYpah1YMdpmkiw+viEgKRyFV2QATArCA5ufxL2gljEulP/rp"
    "6aOKmUCmG0SAiBGU6bqVzfDOS0fTTov1etopEqSvdDSraYHnbjqadl0s1tMu0WCtpaNZXRtE1tfRtFP+hJ52J/yso9lXkj1N"
    "mRjs6DyoHS4YJGWpU7JZFiXDcGk9e2EHQl4eF3LDL2fdz8/Y6vRQxsp+wH6L5oaOBWkmL2m0mNWVC4i9dE2gXoDo+uZQ2zFz"
    "vRB4gezCJzJ0PYyhwMVTnVvu5qymR7RNeik7wzwUPuNQqd+va3rKqSkKyBlSrlDHFn4OqduHjtqbDbfzMXaZJyun24U9zFUV"
    "x6MhwfCVnBKSuwLLTYNYxaWSAf1XahvBXsLU1Zo3NBpmr9LSHDyDmcu1nftvYNIAsRmWBsUK7cqrCaprgJTP8EnZFHGUMsSj"
    "UNjbxtHlmxM8K49hDRlkKBqZh1UYxl1KAUg6q05PQ6miek7sWm9kV12wxZgIvm/iwyFhPDMsVuXlO+KRRhzN7JmNPUv1QoUg"
    "sRp3UcoIkPYsRXBjkrLJ0fkpWD0pT0cRXdxjC5cczeJH2X/mh4BuD2kFgHON9K7TIIDwxgBbtGhSgLth+gZ/gDsN9T8pCHAT"
    "VRotgVZlFKeOGfBCr0LOYOfB6qFDDY3ZbE3S+H4CiwdZ4cxiM4/nYeBmvJmUWqJ37VYT4gBe82CuCWoHvZQf89sdfLvuxSW6"
    "lOIedUsaNE/pmGak9qTduPEY3lQRALR47FUZic7PdRaVk2/YySedO/fbZ53NTuYmJLw+hWN4UjEm/m3l4CWm9yKMaZHfztHz"
    "sDQRB2bNmrU0GidEfRVRlomBsxq8nApZLiqBoxGiEiPB4qUQrg9xWpthXe/evYcfzYTcb7Xr0D4pM5z75Zdflg6s48HvQNvU"
    "9z8i4m26vPqKn6GqyxeOUsuDzaFf+kl7cXpKMJb6PTbbKEWMDi12Q81fTzt+ACihR5M/4VzW0ysA+utoFxTrxXV0P4AYOt98"
    "ymXQfvhBiVIQ6+8nu5vu/j5fWllL3O+PhbEEaDOxl15x/1fTg6TcJva25i847z1/lfMeUTlv6l/lvMUUzptqUDjvVJnzxorc"
    "R8R5F33y+i85r6cd573lY8d5f7fjvPHMjvOWtuO8/f4lnPdbPeeFinrOm+Ko57zD9ZyXh8cKzvv5sk2BBoZSxQzIHzN1YMz0"
    "44JS/yAfflvmSz78ofKXfPj6l3w41/1LPtz0Sz489z/Ch09/yYeXf8mH+33BhyH4Cz583mDPh3PK2PNhiHbU8eHUy/dAC+r0"
    "qFvKyPK/B1sjuyXQ4GHsFGLM/PU7J1Nv3HgOkb4icqV0+gQ5hGVntKgYY46xkzETJix+lN0Oufiff37IKMv4n+pI3USFbX/r"
    "LioFM+Yy4ZqYmOktGPOoDuXtGPOFmkTsQ8a8JgbnSzE1hKWKGQ5pwYN74J1G9AGLk0ochivKX0xNLDAOidNr1qzZhzMxupB6"
    "ndx5LnQd8mBsgkRvfgf0G9dYSpyknKAL5JZVCcMVsqSqETU2xJ/qRX+DZ86qayL/a2ipMOaKHl9GsCRsK/kFY7aM4/Q4Ysxh"
    "fXH1WBvrQz6WAjzS02UksLrq7fZX7YP5jDFg9dPRzWgFaLT/RbJiIX3wJyxrTqQj3y+mvx/bSg9+Px/fYEmXtwYrv28OIhxX"
    "Pd9x7iLT6DK58MpVH36zlKdX0mjvRMgspH+eQQTt9SEuD0Cqr3dD1PtIeVPLDl89lXSOLlkJp+JtiOZirhmY4RepgrOZ1ofb"
    "D0HsePpYsTPRbXVq7oluXCa6dT1gvSMbG4Jtkxp+JDuuZ9rPznEvulTseMBWjwUdSwFLFDfUGQLlbdnV+q7cObMzXzkucrrD"
    "Jzi6hhuQdWrKoL1JkB1Cccf8xRd+CXCHTYQE8dMOUq5rX8iRI5dcXSih+SVto+lwK1hO9VbimppdwDWZtbed7IIsMoXs6rfV"
    "nRFlV1rgo7c+3q3Dz+sUtvgcFtxUHKXVJWg/BGAd5eJrfhmy3ByXU6agh1aAZEok1vksCnPp9QHlt/5VdWmTvBuNHFBfTavU"
    "PUaYhY5yTuzwswYfegjr2btFbXzKDT+JnKYOxUAp/Hs/skjKNqLssMReyXEsBJpXvFznJiR67PI7UwI72/JA3T4OCpK2XRyo"
    "5Q0b9oxf/PA3SvYDQ70Nn3kkmJb+2anVZpQt0hzdiX3X25RM5GowGwwesnuZmtGkHcCmX3QpFnCYBwSj+l1btqRYwFaAPGKW"
    "Xwc3DOmwMInvVHZaoeXLWc4HvOPeaOxlKfakZlV0rVFLXvVNpogSOPvly4/w6uXLYD7fvZWJ/09VelvoKoUmqE6pif3YYL2F"
    "z6Ha9h07dlwHC37u+EVBeem6Pvl/hWppk6GMoYreDxVSpL69FzWpsT2d4dK9L5bhAE/p2FeO/fcB+6RJ/3+jXT7BDrmbuSvB"
    "a1LgHW6ArQIt/qHKYR5O8S1UnALELvakO5RPvj/kqw05qxAg3s5R/KdO3HfgMOJHZQ03nFi1sPyCCL7rYs1/mkL8pliYT8Mv"
    "hmTVJ/AQhrBzMEbmKxlQi82H12KbyhiKJa6ZCQ9G+Ru/2prNoV1YJkIJSsNxgLPwBgdfI/IMX6iGlPjJORa9Q3Spj4JCAneq"
    "SJ3RHsZnh/XM6hPE/2+nt8ivAeFrMhOih4EWBheAqDdEF2aNKHgEKtGvlc0+iBhqU6zsRm46N+DizHJhJd4APB/fJmzoBRm6"
    "F1dTHMtIvuiyKwhGcu9t1HI8GMsFyzMqRMRle00s2B54OM5gawHnZB5Af/k88v43OA8L2vqTnlYfdSV634LD+9WM/cnNkCsT"
    "TCWF/bEONJuSyWWj4dXmR7JTYkG28ta1Cub3LjwQYLDqUQqdGFJYUtOlGGJgErsmW23JiC6VYEMhSY5BX06xXv4W+cV4DvE8"
    "0Oi0vBbDwBbEdY90NxFhzSWpVzbfgOuYJKtNB7lLpjXk+sr7NOhVeb8rKeRd01C9xY8eavzGKfxKlqcaUm/xOyBe5MU1/I8w"
    "IRs66dwJWZCqbU5uCPrEsMwYAVny3rvSIbrQMZY/pIijWR/95pQAzygFl5besy3AWsqspe2C3kE+Xe8ceKVY39zS4a2R0Dso"
    "uK+LyDrSFdR8aQdFSin8aryId8Deea6cTuCKXiAnXG0Dsm56CkC8kcEpSQyEn0XdJbBBOANRak7S4q1pN/dlbQueMQ7S3HDy"
    "6ALXltGe8dEg3h8mkCVyAPYnWDWvluEFZFcHu71riHEfgrqRRdYrcUrb7W9+oLONi9IzG9JlwVVyrIxPXccVq6MkjgqDGm4W"
    "nP++CJrGmp1ZJCqhj/EJd91hbEsk5bMvxp5iXwy3uI6/83Ckp20g5boLuT551vmG1J/u1hm2MlVyZ+fSuR99Rpb+/DNPQ7UV"
    "ZpIjik/m/rnlyaPRi7F+o3QvGWBBE9q9s8vjtgr+OCLeqiWXGzB3uvyWGzHtM6FDa8gmvjjzQXfhIShcgM8W1wyeXqsnJDIW"
    "R6mYcRApU/EK2sl+lHKV/QofCHRfpdzLM1CtMb63fgtnmDGdtim3hQyHOnDJlGj2LAdQlN7CA+UXwHC2Ebp0F2aMeOj+GJdZ"
    "S9i+VGxePAbHKDuUU8rna0LNngUSZ//b8dhZxokS4eYOSgLVIDk7nFsGJInZ+8A2SDbu03rxCwm0NylRy2FIs397h+kD3Fqk"
    "vEdHKZWQdXbRBxnI1ohRJcE+rSNbCVAfxZYwHow5J1JRXwNbHnYeJAKIPhYAMgU4ZFCa5J9EaPf3IPhyeT7LvwX+pPQKS4IH"
    "PXjgYyl6QSxzToNosPryqd4QJ3MKnaQFXtNC9rPLYPPk/kCbBz5zFF7yADOmwRO6B1QYQg3vYDayvXSXMiCY23coAmrREAfa"
    "oGU3cVl6xdTmOXz9Xoe1i+VXABlT4UEk36o8Bt5dAkloShcpbSst/WKoHNPLkZm8ByrWIPacqEGkeHKuwNNbB0F5c0YZOYc4"
    "f7mDEuNuvA+3ZC5+AmJor3e1iZxRNh/CiqWScC+b9RP1/rfM8XYkrY0DnwvNzuFMzff9fYvsrf0eHgleZLxgtYoVOc7W+u4r"
    "uvGq5sWsbOYOerERvahrAMqYaakcCOxLdnMZPU4JqSg4fjDzeK3kfzLdhNsG2pckMv1Ng6xy/GlzaGNpjVzBdZwj4aELc30M"
    "58QUrJIDy3GdJCtutnEgzZO01AjGSwC6fBQ0Acy6TLrkSJ6s59aRkKsEgeVPgKNuj+GZWPWGExDvR8mTxMs0hoLUjBsfeZqA"
    "clkiT5ThNOWvcroL9wS7KpCIz9YRksrJp2xtluqwYiG6d5B4h1Sm7e1WNe1Ynue0xxd5/zsfLQ5rnXBn71UVuOd0U95vZKOu"
    "fwJYhV8NOy+1OLcFKUnaabZccyAZdFfZEEYZKKcVS4PsCuptYC/mRurif3lHklFKn5DCeBd5dhH9YqxC7+YYqncjcfNtlnZi"
    "MpZfRG3zvppQrrkEnwu5PNAya/nGc0tKxSw1wcUhOZnxUNRKfWWT+lM+DIZjIltmqXTIrSmr9O/JxOl4SxdGgJfIKFPDQm8S"
    "VMo8G0yoL4LCAyfn4xY6nNcvnNnWOE8y7iAyKZC2hDk/5QEX43IrTjZz/d7p6e1MOV9iS4hTBECimj0yYcXf1l7zaHW/8X1V"
    "B1vbieWK5aiROxVzoTWbB/ECnRguEZN3fyv3RzegN0ki48gl17JnvAh9N1yBSwYay3hhv6hqxbPheRS8swbPdgmuKRfMlwQR"
    "YNU2HAwB0Ismh/uQ5GsXtH+J/YvImfKucRTxwfoM1cVC8uezwR0trWrVXDhGBmg1ta7hOnEo38+Qkl/j/7Ryh6s5VLwTIJNs"
    "RKZIkELlq8vhighf7ptEx7yUofFefnI6rYLQC2fSyXuD9qZvSjO4FU9rLqNN4RiQztsndO3AXzZpl3AbUZ79jn1KEvDQPhVH"
    "YbDbrf5vbfFKVRPNBEwWocE+VSky+EGy/MKfkmkiwYfT7XjBAJfYxHJrJYmXMwUmRnAOYTyfXlr2AYqXQlS38Ji4tr49ZcXk"
    "O9ZBs710pbegam98QFApBwT/ZpfU81ew1NMb/KdrUyMFrqhxvY7hyouq5WAg7aWfzW2qeoEP+QGi1TQlxjOQo73VaKKej9XO"
    "hT/UUfF+BR+0NLS7kO3IAXQuzE0XE2Yp4pKmUTlF3IL1ppf87Gc7U8td+9cGIBjwU4OAv04A3T1zb0ysLnFfYxtYdVk9/ONp"
    "S7EGpE8CXNUFPI8BSNZx31pmfYoi5vnCPgM8KtpPdFkS+2rpF7lNMgMUXZ9LhPsApwx21smEALv5L+letVo4SZcWUyw0y09K"
    "sN2csQ7R9rao8mfsyPSARZs2Nfp449eGH4cz9pf/JcX26tinTymnhmFhYVVpjzRe1NgOkvftW4sC8Z6Qi//pw7PQ0Eokjule"
    "yp09f/78XkNjvmuxmHhTy9qPYM3MzBj7UXDF/5WH1KioqD4f+e1uGLGWSv3hIutKEzNfLIZogZBGvOaT0Std+CvWiUzSlSTB"
    "LK6IGdE1mU86x3ih7c0SOWOCLAKe7BMJw/yrlJyuTsYwTYM2RGsph4drW9y90nNV9XKtxjgqKa/w5mprJ423qKzRMV4qpwkm"
    "VWYH5aZ6aHNXfWVJI92NPNJuZIh2I3lScwO0JaKmbS4vvVVv5IJ2I60zVxfZv0X3At9CVv175BCjvdShq6YAuiVmeAK6NJhs"
    "JNh0u9i8M+yk03r4pHudWBV98mRSGHUaKCk+uhfUOb3Xv7yOzYYs3VtLClrsbna/3c2G2d9slJ3iPszuZj3T7G52td3N2r8V"
    "z/6NeZSKQ3ezjnF2NzsDsnTy2KNfX2OXTZt+/ObXh9dRdfvL/6bFpl6v3qdPY5dGyFUqfMe9lBX37jsNSVxV+Ld/utQL/R6S"
    "+HWTapxD/vGrY09iH72da8mbyot9yszMkbXl1v8PHQMjoqJe47G2eI7meZYSZ1nuw37cV4BNebLxcf72biwYFaGyN+7RUisT"
    "L1nT67OicfEtg5+kB5fojVPRrTsxCb/1+4QR0u8hgI1yaPlGwtvDYO3OTHcoK+l3SdbmhmZ8qvi1CXLftEUupXXVWVZ9yQz6"
    "kjZUCf6iBNSDL8vtv9P0d3547kVB5r4fNVnmw5zqBKPiUzcbTiGHCInjYjPomlSF+ZegNxmZ4sQbAiu9FDY13wtgIVDmuOje"
    "PJZ3VfTLPbiSTjxp3+7mExNrFURdWx77aubh5xDCdr9b2bknhIRai1NirJBG8I0p+B2EGGZl2j5Op5yHjkEKeijdaXhrAR2C"
    "+Ct8pI3IlpzuQfTUbzd+JOBYD14SZ/saJLytAtwU6pwm5wko0GLEqiyKbnLvSWmLbbTLqnoyJG7sXMHlLdYfw066jo8EXb0l"
    "bnohRbore8kRRul4qg+X4OzSk+lJSXSe7ygPzYVK1208AimgiqcOAjWsLoMW5wn0EmTpJSlN7mTnSKQIhi08h+KWcgavrrcp"
    "o1U0HDUJ3Qz2MVd/2Y6QKL9qHs9S/ut3hEmZMWzLS6sAqAVpYyKkRuz6AIl+qG3fnED3/BgS1yp2kzxWSHwIrxwVzSLxEqTz"
    "PsmDykTiMIDjRZhTvSt0Ns9TFLGbiTPhPp7aYR6lZc1Y4LVLhBIFNSwmJMM82c0Su+CL47Kfoh5MM7JYy5Hui2yzWexd7MrV"
    "KcbYpTzIqlDsIm7RLRFLMm1qrmMsTCzaJmU7e/JLuGQ7xXU4b5JlgYfW67zl5r9Ud6gyoENBUa/JfQ4bHLEuZafsnXvTBjvI"
    "6x5HhvkfQaoaCnIoyH1YhN/xlUXgkVDIFCccBXfxPAJCjoXbofLb0Nlm2BMqu0RcYmA61rMR8TqtheyCoZAeCzFn0ikIs5Il"
    "Mv9xxKRvFYuqQwWOPdrM1Cf3wjHRUVFqmNdfo/I1ClQowwTKYv9uoQNRHw4pmS3yUPZieDKufLXJsWRAQSqev3CsSjak+0WB"
    "EvQyF2VsFEj51DCThVHy6895PNTBKPVVNa4AZ6IgXrF08L/JbxenXdeLotTw75kAfSgrMv9j+UzI8Kd7eTCydMXRz+k1e1EQ"
    "dVyJFPJmp2Cfw7wX+Axxi1WXW776MkoyTr76+g8EXKvSFn97xlzNOWsFztzbY2vJnoJ6sqPB04Kqs3HZt+yPV18Xmo+4xfNo"
    "FqRwI4pjQTFtHWsO7lKJL6r5PAtheBVu53w+Z/N7SC6OGu9gHPHCn2HPaHmBdM6OOKy4WGkbpgoh7mq23W2y+m2sVKgv5OYT"
    "Ktuzormwwo9rNetY51zIPRVp4zzp68t45awN4tFMlUo4aQHMDVUw1vkIvSbl8wrOSfoq+9HjkFf2sEH2rmYBXc8BRLljJ+Zy"
    "01SepwA9/CTlxbjVLbCkoxa6H1TGea7uRQB8P1oDOyWusZ1upPzOv6RjPpsSGFglFxaz+yCsSGQWG8i+s0L65ka+7ZEFv0Mu"
    "19OqbCPlsqvjEWJ4GavVBH/FGxbT5bLqKXfltnD16PTz43tTdoSz37Km97xoCc9Lr1B3extem5t894Q34A7B7eFBFMhkiA5n"
    "F99+VWIphLPC1yXrqe2XFN6hls2HNC+O/u0cf1sv2LE/TguqO22kJ4ipSvW9YL0xd38qjldoLYmbBQujGhS6jKy6wkId+oe8"
    "O6cA1h/J6c6YBUIfyJzXaIPQQ/KwVMTvzIVnTrJNO7SoGVY6kVZC18IBSjv9Gl5m0f0MfIdq5SHfZxa+GyOg/BdJGBlrOLOP"
    "njwFkv79PqcB/grp0zBIIwc/x8UXu9SZkw7r5JEMv0dkT5yK80KLD+YpGkyOL0DiETvu9GYCUx01OUMlIvuA0gsGHH7TAi1M"
    "6CySv2gJz4/b//Uikn1VR5wxGcm6alawmvy6MSBxAe5Gm3RNZAFInBZSuP9VflfMpLypIuKceKIRxE7ernNbAG+EGM0bqrlz"
    "frzyhOKv5n7u2fhYdF7HdJzyrsn9Q2D56NGjX68Phb2rsfQyxZFJzNWBzY+t7NLf0pH5TI+xfeLPZywgZIOx2sD68hIeQ9FM"
    "6TzJxghIXtl19gsa+DKShVZXwXjog5rEUdnysZMdktNDNoJn7AnYBHADKU8U3NomylrHfTqzxHjZPeFdpyArIHLAFo6ixdlX"
    "gie/7EuD58TZGz3Eh077WebkeaoV1BlBytRQ51HjnQjUPh/ox//aAvF4Fm3lIk20URZEN3Ex1joKUg9KyvGZr3e322D29bIo"
    "Jm4ExC3bq6mfAwCmIRPdK5vJcuHIaj2kjFyC7H6IUkJ7qK9mld04Oi3IGAVmsTRHpaQ1YaESfOjqxYJWSZDkw9g05C9mUuw/"
    "cttYbXoLJk5Mxa3gXKWeZgvzQu799WvYwwxJB8p74S22ZewnxIfhPzSdDCsGV2WFOM/7rz4DVDNWYPvB5OR3wnUBydxdl3to"
    "4vccXw0XLNzC7ZE+oY0BvgkNLaAYzw612bEb4MiOHb241CymiM9/ScUxJUdLVWso9U1Pwc4X8hmoRKmaU0hVdsyB9z/kURjQ"
    "ak0XFXLawdQLoJ3JhKtctRguG6sO3i7Plq1RWsxs3bp1kHA7Ki+V/89Wm1jMQnd2Xvz43rQRa9nGrBk9LuREeFpQRri/i6jJ"
    "ZcSuiBCe3XdbhK80GJ/teQQ7lvhN8GaIYH5HMlK2748wdvJzMLI/9psSDjuzqqkjWdP3OR+sv9O7iSqFCuFRqGP/ikZWOsTI"
    "nHmi19hqbxRZsDclIwfCqgtZUAhFdNgiWRYgiww7IsuCQKzfVrhgFoTdpO1LNLvNELZdtmpXwe+Mh7d5ZGkc5psOewKYK65l"
    "5IhDbSBFZ8KfFuKOrS+nWh8tdTHLXlVXnlqu0KiszbKV5SPqCtz74/sneRd24U8PXkuG+6gQGQZEmSH3zlpZCpqK6d7pmq8h"
    "Z4YmzhqHE6t8tdJlOsSZ+MuTBfNHFu1Og/B5foNiA6/zNFMOTxTmTwGu7tVV5l+dyG4a88d16j5DY+9/IDlfY/4HkJys+cyR"
    "Y7t3BrmbmEMqkhVVp0ZTOrPhtsw2/ClnqjvZKDO39QhbxLfpuTPDVBkjHbxAJOpPR97B57OjDEdBedWlN43TbYS1/odPy1Hy"
    "uDSOsgAJHjkqXG0WD005V9HEfLtnQSKq8wH0Euds4o7pfAK6LuAxq6/3qZH2/vVbybhtXgdFCfri+Mv8yHszUSkyn+u7NXcu"
    "i6Wgl6OxLHYDty7l4d/rAz5fHp+QUtXN4hl4aItBFzrs9FfqDpX6fu0t6pUo8Na6n5QhSJEuLP1AhnWsxyJrd5oOUDNU3piQ"
    "NxcGhyrxYOdgo3rO9XDwn6lXsiQJyTMf1reZ2dVOAfpsp9Yk/0OUV4MCKjU0GhfNo2UeRKUq8ueEiStA6RtqFu8eT8wPqYd8"
    "zZUEyHWJUhMw3MWpiVRexRYHw/AsWiDRMu3q+FzL/x3UKfVFTWWz4UfD8aGGs3wp7e3O3s788v8XE9rFPMwzGqBwySk/8q51"
    "qF2aNYAPLAyS/tK/GpYnzGHr8fUGepugp7cNzC6saBUl5sBgMhAiO0q57CP/uY+LfJ/Menr5soxlFk9j7Pze//pf+K+lJll7"
    "D74yEe+hyNMXDXhMVm/GPCZM1nYeVgrGv5qsgADZiceD/jOfnkBBrw0h26HhjBg4QZFbT/OxrwdUlvHSj8cPlZKjU3rJ2zT4"
    "i7zyValgtA8FMspQLT2fHNpT8j95XC/v6ToNKcQvwqy0YeowTnxrK2ZEDp81mLTJYbVoYc4TvDd25hcHh/lXPGNnep382JDF"
    "bouKKkFBrSRLWGyctSf/ymyKvsRvTrANZ09Qux6a2ynw0AqN9yT9papDcB2TqPqch9QivFr2OcRU4F9olgxX/Ph3h1tgk5NY"
    "I2AbqywXeRVjNScZwr3l81b/CHfyyZeoEA+R+eWrlYyFx4HyhQs/g+eFK1l4hFOB23C4zcyWenZ0X89jIv8hwoiLRiYMk7Ph"
    "kEy47kLRWkkQgbcArvmL39R4C7DVWZygcybYJspny5FAdkhx3pVdjWkEbHJQiPjXADtMyh0UQSm1z1G5nUD87lFn5d78kLmd"
    "clVu1PsGwAUP5UY9LlBeoFPyXjbX/VboM69V7Jwv/3syJfDQ6lBI/+v/V7LEtJnZ5iE8iYKn/4P/T8GZvQO3vzpVudzBmD0F"
    "2Fvbou6P4t9O6vX6Dnt7lPTBVWTbDXo7D4W4hLpbCWjylqaw1IcQfPP/qv6CjEFZ3QjfN3SoXYLlbdOvPK2Ugj3a0xxqANH9"
    "yCh719vzPInMyeQYssLNWTvMcPmmZefMS2T1CENUjMPQUQKpCw71RnhCTdz99xRiREyWzSsMzE4invWAHCvZMExeBMvl10q8"
    "g9b/5qYaYp6zafLGwwfWOgaaM47B8u5UFljXSWjfm/wOZQIkbHJmpvnRABmnKhIDfybHbu9z3iOboIozglwbahXtm4IoCJ53"
    "KPDVEYDnxhfym3frYAe+IU3U8QxAeWwVL9QJp1c7yAGEPV9AhoPilv9BUQNXvlBSOg5XrFMmgAMvlOU1VLHaGP+XtF5UdoB2"
    "sGaLPQGGt7B0b6+fHt6ZamBvs0/12Y4z6C0FNp6KYm+pd0bZTG8J0/UH5y+PL8ga0NPsSILcodIPbT35fHxblUz7lm1GnGLZ"
    "6bbTKz5SUCROtyfFUWNZAFA8TI73C7BB1zAl1vkq/BSmGMc3w8Z/pl7D8k6xGS7gsIB5N/CXLTYHDBOjcRXcp3cDYh/tkFHX"
    "TgOfIymrqpTq+4kiQJC66SYrCZ+IknNmIC4t9gIsMm5dCNDlhfKiTgpRnfRCNXo3waf8d1AX4bJMVc6x9WCGMRdf7qiJz5r2"
    "03dnkys5ZS6nSPwl1bnute9GbVm5zMMNzXG/seOx7QsvsLVieQ5lQAyfySY5FtNYaUBL2VM+iRQG641AYfV7MmWvmXKpoQI4"
    "CHvT9ylsZyPlYP0ZEI+a0TYl0rXsn3LgKCqRzcJl07MhB5pskX3pdQEK9pEtzivhBSuSA6v8mbFJAi3FdrlgPhIDcJrc021O"
    "p4Lt0UpZFXIor4/6L1pPUwub73gDYL6+QHiwOtFebVKsrpO0bZ8LWb83zDcC0dFVN3p9SW5FORAKujAfm5LS388KFMCiGpGf"
    "IX+cruWjPoH62Txta8B+BN0z7P/aXtvh/Qye2Z95I4XV55aXFQuKFuxogcwtoXmHopD7k+76OzJC078I8Yxtd+MT5dz4WQvN"
    "L1Rbdtjv6r30ceRsE4vNIV/VIhYbaaIUAcbY5dxXVSR2IfdVlYwlRXSqxSkWJhRpk7IbcdFVm+20H/m8vDx0vq8T8mtljCGl"
    "mKnagE5F+b6RN7V4BrPtrgRWMlP3zbtpg8OEYT4U4L4oqB0q22IM92FJqLKdaBWcCIUsxRd1L1RJezgWIkKVHe+bYX+oHK7q"
    "EgOzsZ4pfFHmYqFgfQIvyRc1l/xhefelAbwdJPvMHMrn/6t+tTxjNWOdWP5+jQrJNud9xllkNE5Y4UTg4uEBeflfz8exSvT4"
    "CtzrtJyoRMXrlF0wSn2VN22KR6qA6nVarHmW/AAOf+l1eq15nY5EgS2vuoyXRKl7jmcC9EfqTX7Z65RdiO4lcrjwOi0j4LRd"
    "vs8rPsJz9pS8TkscFa+aT2iBf9Ab98jOi9dmanu7HXrLou/PHLGabcmZ2fNCTri3dTr3aQTzN1rtDq8HtEt1c7hIPnE3nF2O"
    "a1x8IYSzojck68nD4cKnsUn2kSjH6cQjinYaUNXEStc2Mlf+SO8QUdZmh8F2c97+tMwcCK0t4gYLJqDUWgIPDLJJLfSEHDob"
    "iPV7itElC0IjlMjxbAjdL7OhIvid2fDKRZF+xXNhLQ53KPlEKJox/cxLeGIlqTgY8WzavrxmISHzk8/CrPOz/JV637GC7/g2"
    "KqxpU6MJgrxb5zYD4ozMtFOJUzguuwBSFjYoNoS/c9jk9EoOIHSjrTemYDVFQxUie2q7McgxMVuL+DmFpM4jtl/8VVELjonf"
    "jle3+PEzH5JDPfl1X4PEI3Kdr3FPxACApBl1CvY+LxwTjso9X7suHBMjuWNilfNRxRHjHUpq21F7N80/RB6xdwDVm/oD29t7"
    "waUeb7MjFtR7S1GrbykmloMN7YNjDofaqNsG1POvD69rYwf+jkAjA+LujUFgce8rIw+N+l6ESFndxdHM/pGjAiAE90D4eQH2"
    "Oky5kAIzETLwpJSbCC1I12ZPr4aVWxzBvFCCvl4oe95Uuf1PVjSJX3zvq3tTHY2vTzbq9G5eAD2kjz87Zt7XBxmLqcXGN2Z+"
    "Bw47ExpkdHEoEH6HjU3KtUVUwGcowMGMQ+UfetYiHFs3gb+OuyGrlAW7e3+/FzIqzBF7/iZGdlmjTBWSiae7CjE0IgNl1IWB"
    "xME8ehxEfBAjdlA4tHwBZ/0LyAGuKe9tA8X8PNtPgmuL1z2EnLas2U3KNHCTbxZwKV9KcekYyjZUnJ0VT1Gulv9D3nsAVlVs"
    "baBzzkmvQAohIUDoHUKA0Js0pXcQAelFlC6hVxUQQUBBpSkdaYJIkd577zVA6JDec8p6s9bM7L1P9N7r/W/5//fevtewZ3Jy"
    "9t6zZ9as8q1vvZmCm3YjrqVnP+Z/cTuImV9BYmsf5jXVDptYTUVG0mf/PFK29BxjO2RO0qILfREhc366zBFtuZvKrd8YLDNK"
    "Bm7iCh7MVd5Jc49XsmqaAvh+NOvmKjeVmdKW6wGH+AAGvW+DNE+X7RhSieVrIbUL/9POl1HTeL1Hptd6lKsnozlhKwJoIy2j"
    "fs65DldON2oyB6YNLmzslz8rkUj1zNpUm+ti3e44xmNtZYkmiVJbau6TfHX6QladOnW8VPjm45Zrd4Nt7dq11f7OX/35SZYY"
    "jvwAMi/mDSz0l44hyHhBeSxjj2dRLKbsVC1fYB6AGvWvNUzFn55aXBYChLm4WPSYjbWRHrPp7Pdui1/4qm3Ropn7P/6yv3Ya"
    "qkUhNZd+C51ZOSwb7Fve71xIJjmAAol338A3hRl7EUHaZ2Mmem9mxTn/k4EW+ZdxNzAX9nzcN2n9S06EOK9fsx2nvuGbvzcO"
    "m3ttOYwRtT0+wOw1kVzZ+0OlHtyAAf/8uSTruQkDmoKVVInAHBgQDNAVzwehDhoLxyKZ6Z0beF4rE+DyfXj1DPfptie5bn2s"
    "6C4HeQF9Krgp/cjoCOTGoCpyNdiREWFGVg0mveBQ4z/aVHjhLzE/+5GGHbsEpB9keGkJdDVQXxqn/pQ3yySD7cvK+Qedp0Iq"
    "3AqzysowP1KTddrNNcrEX0M+sKcLS9O1ejG5+Htux5PxiyJRmfdMHMPOrmasR3YQ65vhzw5t5C8zeVBxBwZXF5/9/B5+tjIk"
    "iwynQ5gh41JLpayUrOkSBZkihJ03AyqbbsmkmqFwHTXmy/JphjEWkElVVatAZj7KKPuWELlE1VQXK2Z6JgqCWdNNrmJ/ADdN"
    "Up8+wPcBmVORL9PRxJEZoGF5XutFoNHRqNczPkAZS+Toc/L4+qfCbKatlARXdk3W6qSykMfJnyEza/pT2cM86SqZ+DQkeJIe"
    "L+z28pLrtaZMfeYSQZhYVyGOy3m3N5jgKgYCoYydNGQ0/8ZNuE8kqsz8FZAdWMguXS4kGWH4ZKNovgJXY3UeMZFQBX0M6Td8"
    "h0ryNuKTc7JlOlprxDB8wW/QtLNlJajAPNOS3fkbqMBix7E2L968xyY9ZGzBCbZyybJl7DS3pd6xhbxt8u7rUDuXHK6JK+Nd"
    "3RJXJuAYrsM6f6sda4QThT/RezbUnauJLSBPLWGnRZYPdGST/NwlBro6vGYXSNPLkw0PBNJ7HTeeUWPtDiJb/QJfx5Hwho/a"
    "JtiEYb1Q/A7TY6jFPFNfFbJfxRy8fZRw9TnfmX9gJ6AEXxtDKd54lY9fc757feqeiknLzC0Jir1JdGMRjlPNRKYE28C/Fe/7"
    "gmOLLFeK+aooD8aDqPTL7y4H0r2EKf9ELpKNUvU+6JjuNJG0E4uZi6SvlPdFFuYa6Ujw2AMvSB32z1YEDpfgDr626uri5B8I"
    "c8CXrKBDlJndxHvpHXONtC7WLLuAG2sqrAZ7KCmNOD6TwRGGANec4LdYF9UjjQAZlckIXwG/8//2kzemndB+dzDLGxjEhb81"
    "Hx+7TG/he0j3bAD2EOaeDL3YQwme54bZewuI0HktbC+rjHrXJFjymNZeB8iYhsw8MncpXSRne6XzM5Wg302WsyWlXMtr5eMq"
    "z/GxNcLaFY5XItHK567kLmpwjIuU/Adauhy95mU5cNGDhb36aWYS7iZN7A56ngY2G25nIS82rn4VxiyHbvp6XT3h+lFSWcZK"
    "JIxhkdXFe/OuHe72Frmk+Zs6wsV6S4f9PcrmigvCn/GFWStHDjq1XI7CmVIJUrSEvYY02GzSYHVxKnViA9f+GqmVnP0bvKKo"
    "TfVs+Nj9DJzglmi+WOSDKvSGG8+mX+E6DnJTO3Sp7ngtZOQ4+x2pTwuBZMGKH7EFRatHtqMl4hFOUDygYgY8yEM5t4jA9bsD"
    "meip9rwCuHltUm6akimQVHyYTnLXBeButriwzHLgWpqWeoKEdzooknlRLW4N18q3iq2pkCT5//oCnHXnX3eFRFOlDHhbmBQK"
    "hEH43wU7hqFcj9N9bFZJdGEvIatqUAZsktG1Bqkwv8evqOmOWF4RkTxe8RPY4d1cnmYGsQ724uwK32ldnsytR8Qw4+J/pQzO"
    "wEwRpWO/PRJ5PinCgzYsTXgOVpOMdalZSvODuUdCtlB0vOPhHdM1idAaCA8t/MdTVyGKR/FfJxBytgGk5qGE5IM0QwlbU9Tu"
    "KMvCrY7S0kz7hu+se5SHIznotbI6+aZ2FO6YtRQTkHAiysqBJD0X5LSh3nIFsOup1j9IMBltYunQ2KB2X9dRXzViNL5y477F"
    "5Yxviv7N4xwZwfzRMqSXzPMt3DLhbjVaS7bjosErAe6bZbg80UfoF+/KfZJEVoRNWNwbwBYhzVI7PwnNUTZQE0Dc2nTN38e3"
    "5Tcebi/1Wp9cnvXsjlyJaiiS4PRpeKs7KJENzcCbzkpwo8Eabtindjllx5N3srahyQfqPHNOCu9paFpi4aW7c6LsVGegZXaI"
    "sd1mok4WVvY0HgtYwODBgxcKphO/2xdwDzNti6fxGG+n4Wpmo3lVOP5KZKVKZZlIQrV6s4g68ggiQIIk92dsNLJ+rT2h18X2"
    "vQEX5ZCYNkF8hKab25VL4x2bdt9ciuyS08zjHDxUftDlQhCI+a3t/O6ZYL9Hx2UfvlGospN5mIt2mNFnqY4XbrOMRegC3hPF"
    "HS8Y2DH7ATxS2lX1LMisqjx8T3QGFZeDhlxPPqsuqJSqzg6IL6Jyq1LBrop0+N/RE25N3I78TS2kcdzC6tZcHAHXDff23T5D"
    "g++Opvfn8zU2P3ObL/NOG0xrqxQtadyQ+qdziVHoyTbKGUYF0vMIKZ3dHV6ENy9I+jNqUy4v55kJov0cUwiKtpemQKBgzGny"
    "EBz4ouplQcoaC+3/a+nRPNKlLlYY0hR+6oV0wStWjI9BJCSadkr9chFyFdI9yjkb+ByuCMxaqbdKnZ2ppEJXFcuupVwfpRXY"
    "JghnmzJ/VNr48wkkCL13c3ufJpdrj69/Vt6F/C1EnYao+yAsp1rJAEI9OQA5k8khX8Cm4Lq9NWdaDECQ9lbdlW6apWnU8pnZ"
    "C/msyEopHrZuGmRTmCjPS7CJnOkC6Vp9lw9skF1Yi8lJMWZK1rhwT2r1mH9Sdjlq0xJ+PhFALoPBGpdYadC05cuQ0kq8x/e5"
    "dIkXyeTdskG5eYObjxvQtdCLHn/vf8+6B7myfG51YFNz2P1v+X/lxwvWP+wZB/P/Q/8/zYW9iXUZh8pltztvUai4vqCU0E3E"
    "M/WDYAulca3nIMt/VyqfzK3suPPPpEm7gmbEduSyDE/juvRE2yW+10bVw/nkVUW8/w8haxeOfqXjdirNwFjBRAnzXCAt5q6S"
    "gqG5jAjXgJfCYycRWu7ZwkrnW2AaeY+9Doo5XilRwCvPwR78ZrdsIrPjdlWmRSycB0JqyxzSQRJieAJtYNfGy8lh04PPfwyp"
    "1Ng6mTYOt/eryYlbFyB7FZ2XwnT6fbSS3Vrs1tLWQ3I0sogtkGFWWagKVjZSo17royEh22k029UV3xULtKpljRwpe4VNF3RS"
    "IxiZDZL5i3/hQ7H3PYeXxRUWe7a2kmQqai9tC/wEoLRa78rZtBTsQi/wSZLcgqGLRFAp7Bif/o9x/SKB2DVSUvPOGVBVDEdg"
    "x2Z+LDz/vaQsa2xOw4Zmt/r9+FX82g9ujZKwTOlw9IraL677PXtaB/ueBdsxCvomKg8JzejOzbgu7Fe/Y23B0FaHfYAuy5xj"
    "M3qPOg4FXxuS6/2frKgTWn3EnjTIOVOfKXnkTxNnxDhfCzcA/uw/84OnRSyduvmGArwTaHXUCh8b0wM3LisOmu0v/xgEkMLM"
    "RSICWOvt29d4IBF2BP3g45cawIpGRxdn/lb+nIGIo4PC//pP77cAif7M7OZmYV4TZ82a5E3l6d5tjD9biJ9l0/meXLHcT1Oj"
    "fxrdAE53gp0lYVMt+N7bMS8cJrHifqyUzzc7dzYou2Pnehe+zQ5D9i2PUwAdIrHGG9ezo4OBbw8LAMJM2fAb1xj5ArkHi5l3"
    "Y/5+SjYJYHWnTp0SwYZMnTrCjKxS4zzwwgX5xIC+jIt+hzuX7NAUy8W9xhUDZRHDewkZrcGPy1xuAnKBmkxupe+Z6/7rXB2q"
    "e/kqKUvf7GINL5JojzvHJiFw5m4KWFNyIO1Ltu0axJ7IyDgxDE2Q91kSt+NcS86DjtHwcwlzOzUpoksujE9aeAS2LeTKWMIR"
    "viBwVpv612S1e8tV13Qw37CKDv5QKsIJqI8sAYeP8szOx0gABhuDJkz+HmDP5MkJ8HTyKHNHp2zYsFZOzSCXqOrHIb169SkA"
    "I6pT4tUt3GWnqmXlQuWP1glIQ/+ZfHxPz5z5BFJmzizLkozfNJm9MjbHsvDK/K3UqcwN9RmVqQTAPqQ547pTY+Wz3I6LNklq"
    "n958d2EuQYZsp89everBWMDdV7fctbAkKu1NQZNEliz6uk8klW/VTp2QZPaTTp12ciu7U8cA9iZXMvAMlpKrZzY7Z7M5+PvH"
    "XBW+QGzWATK15wthFSoqqifkm+KjqfC93g6CfUwAzetUGago7irJhjM/16XWYeTN6ThDDg3jcZSFt2//gH9B+/aT+E11bt+e"
    "5H08saxwsafAJAFA+/xnums05GbsTj5Qo2IfdtMS8lOknebWE540QUnT+gXlr4Sg1Xe2/6Q0bsYUJydP83kTmSUJ4kYLJEIT"
    "hIff/xwFtXfHtXwUz5o8CnDL0IVPjLJ9ILM6Eh5ARPAzsN16SfdQeD2Xd4/n0Q7iozEamGK66S/086tH3Z14D0Cn+Sox4Cm3"
    "FyXxSsBqyevyM26rLme10bkcJPx6r74bvPi58MmvB5G1U4a/2LdmxLoLSoLSrVs3opkBD7poRn+xRPrafZ9IDbyUosW5JGgv"
    "vTptFCaCXRkmns3n05DpDKNe+MoGFrj78EGMsgZgsoVPftsQC3OJxMTpWuLVZ95Oo2wLC7Ms1h7hEm067X7CHSF7/2hlFZvP"
    "ABQyDM4RrbyyiPe+39IJlhsQ6ufUbuSAzCBjB/qZjJV9830OxvqzHS6K7IIrn5J3wO1nAz1QJeZMAQ/xVZBqgg/Kho87zKf0"
    "hL2Cb4kcJvmRYtYaMBw7BE6gyk9r164IpEz87QaHqysN7ZOJ1TSE8Rx1yZVt5ec+ylEXzdgmjMCq375QXW/l/ZvrzbshS1rq"
    "fDmFJlIWwwTmbEnDwQfZ2RlfaE4APpMPom+np9IZAGZ+InJDFk38+TGd1SGspKEOuoW5rdWbDvIam+rPoZuwn5mql08boHlK"
    "/8ZrYJH3nlxRry70Y5qZwTFVmW/SvQSuaVoOJJdgH0Dhvo5QNgNX/EAI6gIlmtnRiV44Z/HB6+Gvz5Ci0G7Ld9WOxxeJkM6T"
    "Lx2t1jrs5JNo45hdwtGrM/qMIxKOuTSEWhX4e3E/9yqM5c+aOtZamMVkIYHBqBev9MGykBpibjC1gdRH3D+K4fddFhfZcwWK"
    "cjTDmOfdyfdELKwniUhu93VhnSkEUy4NjriQaGqIDv8w5nMTXuL88nNAc9xIA7j2J2n09sKP4eiHHaBZvaJmbZPITPhdTZBK"
    "0w9Pr+R/D54Gs4LVNAeQaTNY6zTkmtyjiRr3CnzKbZxnZ8Ah7jU6G3aY6oE9PzfIyD2d7xHE5uOjGY9S+bgwQbOr4wtLQCX9"
    "mDDs0F9V3uEoaT6N1Hz1rJLNbxekv4CsEEz5uSjeXYlvXmTtaOOcwGoRW5dXtfbR+iYWGo031B6pht4qLrKameAoiw43ckQI"
    "sy3wCbLQonL2fflFkibPvEu4Dbj4C2Q+2XCXCV88uXsfgJ1gH8nk8gURt7sHDhNSICfy3eC5MiJ3IrYqr50/tYVP61MaY8KR"
    "/nsRYzSD35kSPGdEUQ5zM7vud2Fe7dc+29DZB1XYz/lqr2Rgy0Ev52GXlijyTlYyODteFgjMpK+6qUopOfC983tf3uKwypGK"
    "SKDiC08g1R3L2tLcdT/HZQt/+3Y0a3xBkJN9A+SUZg7ZeUl4c611hPs+xcLKUM5WyRRF7MwV3SXv7UWT3fMKl0HiJvyS5JbL"
    "aufABQUXrDgnFs6PDc+djWySpoR79/ljhZPY9RDq7rWk0VVglBB+78BFc3+x27udgzM2QSPpztXFp4VZo/Hhpq0Q+xamsLtQ"
    "vAxk5q/0BnZyC60yJHuzKtlIaWd6BLd+uCYyVQvuy+BbXqd4QhC7FNRSW72aTl43vpHm6gy9TA/yi/SXmR/g5NLd19zqctRl"
    "bQHHVUboLgmEUHGVeZxVHAXTGzEulhMAN5bbdYhiYZqZ2SPVUHyC75LYoQYt+y4Pk4nU+71YQA448nRFj15Pvj0c9B6CYdst"
    "gCG9TlyOH4rDV32dHKQCeIkq6zI+K/g2b/oRZWdxCvnB/S/niD3+gCdzXaRt9ly/+p3P/w/PIJH5pXasb5akzLSULOXq/L6K"
    "vT+0uptTz2gyuTK+0z3E5oXqm3d4GryhALcP40ahESbjA84hKKpyc6MDRUAfbqC1wVSAh5I5w7JBuXposOFuYNX7Rue3BVlI"
    "4vASa3Undni82Eu+1TUiyxQKTdvIc9BuwYJ+XLgekneMZZZ9+DAcJ/cvH0j86DY3Cg7OpGRy6ME6Y+d2d/4+7REoE0msdcLO"
    "a8Lt+g0iWzQYLNdkC4iA0w1X6XYCgWQMwps9VNOv/MhkMdVcBZDV6UBWebfvdb1mLgI3NuJw99lHys1VbrkMyACNkqNA/eIG"
    "dz239bihx608buJx+w6NO7Tr0KRDaw4NObTh0Hwjy41sNrLWyE4jC41sM7LKhD2GmCE+C9rE85Vf22rbHcZV8UmkeAQjNjCO"
    "oDRXaNmeJDfiOcqbQwCGP6S7UBC5JiFSL/Jd3O8YgXq9Rv4seFLMZXGGRe1Nwth3/WQyHIvx57MfKIn20huur5j4WnxfhLtz"
    "vIRX5AJhY2Qc6ivBJYQWwhzp2p8ik0cpFLdEsvZNB0GwMFR6nfkiIX9RQLZMl94mSYXbI4Md38fciHiED7TrBhAZCJYGMZuF"
    "KuJecxTObdMsvo6z+C+IDiKbio7ga2YhOEMWVyLkrgh0XgLB914Wp466zDLpWIchIv9CunkWgkxp3qCgBQeUEoS8O9Xl4wqM"
    "DdIit5YDIrhW+ygm5JaKBLiATbkl96gvwllOLMdeaL2dHMCF91CCCeEb7WsTj8Nn9clMVZnDLbp2cJgYyRtcj2l0CV74ENNw"
    "T4qx7iT36HVUvoh6yBvsfNfJQ0w5Benq9ciEmQRfMZdWqVyXmkTRxq7L6KbLSFBCgCPn3EDpoxJv0mU53iEFAbx2gyxWFpaq"
    "ckb2yveML3iLdAxKF1ULEBzV6JmKV4LaYZHgiUwVbHqixNYF6e+TDr/lqr7XDUli8AEQBL/gmERa+hhkhyfFxK3eR/PHffOs"
    "drQLesweIAhkSI4kkZpC3GZ2DCLkJ53YgVPK3GgvqLv0w27h8esAytGch7+UN2LbQoLJ/MrhJ/NvF6ppQNAc4e8cr0nKT0QU"
    "QyDIJXMfzrKBykMoY58YuBWue7T1SsnEIOn/DkP5q1JuxJdE8NF38EVTeNwDQSZelEhdUuvKp0ysKfC0SfvImDC3KqvZJ9Pj"
    "yzG/ixvsXy2rG+8A6zXWNj3zYhibktjvLf+jADMOn6lMhTwqXRwDPuVH5cmGYTWR2P3eGzhutwaqct9dK3Xi20jO2OaeZi7D"
    "X8Pj8sz3GVztDVhtL2hTJ48DMuCcL1BZhXzdWUk5CzDxbT3bw9WfBWYcqpwOJxvcuGfim01OJiTyQa+xWZPDk0oNnIwW06Vx"
    "fYKZK6112yihRQGyovJ32vA1HHF/Cbdx7MLWNWC9F0magEmV1K441ngS8cEHX8OGDz6oMEZeY0nBdu1mwap27Ur+8cOoQEzT"
    "zDJL2y6G2ppReuVnoags/octS9+hQ4fy+z7K/xlapKRxA5paxNgazypUr169N9cEkeHN669fQXlu5hu0vyo1DVouq9arh1MZ"
    "hIdqosrjmTMV8T/Rrt4ZD64KbMd/OwUlOG+xc9Od24t2P8ODz99U/Deu1796/T9vn3YmDOeWjWbFd/84PBDsRepyjacv3268"
    "MGxY9fSlC0Uw1yneA0nNFxDZcAXmZkXQi//Bw2jwjd+yZXOVwvgM9ZEX9p6Jq+gQgzUurAXQEfQLMqzbG3LpXxb9ge7DR40a"
    "NTK4ED11U4+xyJUcUv9rcfRdJofj3lJ5cjdSEh238R03XR5DkXBOHflb6ucF6muntjymioozuDjzGDI0oARXWQvZoe4nly4d"
    "88cdrRT9+JobavnD123Zsjo/6kvQwfizLhetMgbc9zjxNbs+E7SsnaROfkhEK8o5LslEmP4CFCGIWAfLqXfNQZ6CehIjtUHs"
    "lCHZAusxUWL9izfwcNJzg8dO1qqWfa+2F0K72ZRZ94kG7keMBjRREXUuy006e4VC7Ra0Qpqa/dN1TnLX5zrYrrOhZtNhJckJ"
    "7PfCTYfXqDXimwLWMB0NsUlPMtGSpPgruaFuZaM++wrkQIoShV2ys6azPxwl1+3YaqDq5zuCQ6cJR6fVPv2X3NLV6xIisyo8"
    "1lmoujpVGUD3m4GOBmmg1ui/XAzGyu1+KWAk0f4IVAYojTffjhO8tGYD0Dn1GbEy23XHYmiOkfUcKRtAr6brwre4WP12O4KB"
    "Sx8pbSFTZ4sv4zAW+0QCdqGGqZiYkW8WFboPmQFEaSR/5TISZhkQlIM/7u3ERpan/9eftcfdMuoZpUn5MPMVeDnuBv4VX0mD"
    "8F3eR82mQujDT8HhxjWFiKkTBwN4cwWmTGx+Phu86gAsXce39zSzP3/+d0JuYzbDPK5HCNe+22f8ld6TrpZgNRmCO0/fMK+P"
    "RG/1klJzrqdAc8uDr6IiKD9vjSKcRBf0lcNSszD5TpI504yxfbe5Bp/hGssFkScr7eiPRNhl3xIx0oJEbzTxqiZhRMgnaT4W"
    "8oHqiWgBDnKURPZuqP4SyYmu7hWFSqogxrg3LlvSfpZL5y9uU88opASnzZW2U+UiywUiskUlNi2cscjHCpdCiWR+S+L4b+J/"
    "0zyHfpFGjI5bhW5j2hTTtJSg9cKaS50ojOLWerDxIi6GQmlGNlQLYpjwV/2ajqKeIVSCBGK9KbKCZ7QYCPu1XUaJvpDO3cK2"
    "M1Te9t31JEkZ+wJ6UXxpCBE0+jKP1288KMI0jEIdnqwnzMYJADBCdpy2RcgOyq7zr4roDuLn/oSKWRZBoCpp/DAQy6TAqIx7"
    "Zmn11pdifKQIx4DDr4BAc+clPlMyVoSR/8PE9fQbvoDyGmKvwpqqdFlrrxEbu9uUq1gmI+mkgcrSUqK+rrr4jJyAwbGyN4kO"
    "qBuO6HAkV1iRhP+W6sbeSpqgP/3XZDbHwwiz6ZK4aIqEQgk6lndiYj5Sss9lDs4I6Y0qcIQ+JaR4A+kFp1ZjfLYU1Sr4BjIH"
    "fK99svHpSKa35Lbwb20VLlWqFCbPNyhVqqCYPMozHlTZqK4UKpJpCHsrj1u56OgqBo4Rn3XK6yCF1w05K5Vglpgt2eGmuYdE"
    "hwtx5Tn0DjP+/eMehj8pmwo7cWPXv7TJIBNz6iCf7v9+xxcP+RFHoQ5+crMcO+ms/3X4Y8cqpzbG5bwHL5nVmRvLRUmmHPbn"
    "ZvSrgVw7G2rJRBTifS598gWasIYouf+LxkIcLoImbyEOfdXv2+B+uPj3YWGz2VRM5ks8qSwTc9AC9fvwq53f9qkkpm2nZ+IX"
    "K1D8vKdRru02Mx/0e28d9FM6GfKNpYWPsaVP0UfrqCnt/h+YW0REiNpatSJkbfml09QEbJOl2YLMNAkdVJKgxQdFj0NSb/pi"
    "vqK9n6HhkG5NH2zAvFJ4FGBLDYOW5eI0qm5bDY3XspZb7UHTOxfXvHd+88WgJK4RinHkMz2ii1qDl7G8wl0XYb3Cg9GtlyfL"
    "LJSbCB0ppLIUJqB/XhrRocTyxHxXbtiwMlymxOtALolGBq1QDZPlm5/rFspIWhFarM9dPKsG+gwjzku75p6MJMmSpXHiR74l"
    "/1DLXO1Wudpa9KOQkK8ZD8VxJTgml6MQsQXOHT3sTu2UQqy3qEVblbJR8fiMsZ5jx449BRkC6POxPV0EjqaBXdxKPrzrX1Cq"
    "WPoMnJeIaAJJupBi6eRIqcTc9nPlI98TyL6QTImyxbdkgu22SP42hwqlzHOEViRlTBDiIPWjj8iWMTTzfr0YD9wUX2pVPkry"
    "G35RVrNw+WC80FDljbiMfq4V16yGM/hIb7WpDDZGE/lrPn7yDJl7eoE1ty6au0UcXL9w5PfYvHPnYInsBUdBE5IhdTSxvOhJ"
    "OStcJvD0Ck1QvijM6zRjZyJJ3SbHcPOK+62BpqKGVFGiOdBYRCXSxHKJm56Sskc7PsEt0Hjw+2o7RxykIdzX6StL44Z9Xw+0"
    "VEdoxr2CWrsJyvm7+o7bGR1Wd/R2NfLaPF3eRem5PbWdRQJKdBsvW3qcCxYtWmEghbYfMudhBCho6OhPK2rxyZMnRut7HbTZ"
    "BaqoSji6sdM8B9LK2TZh4jG6mU3MvMP49K/5wvbbqlepOSruPnoXrZC4XWN097dvpTpGl4Lf8AktNOtnhwYroLMy6Unb6Mzj"
    "CnzwNZ19A+sZnbV2vCoW8B0cLOOpqAqg/xfX+JEAKddayLCtwtQv1KtkML9BMTGDNXlmIU0jv9Hy0FMl69qMTb6e4IHe5LLy"
    "0Fityad0YqExqlkhA12Rqul1nWwo1eQj/MhfazZH3vgBAwagG+vbOR2mOU2qk7maVReLA7WoHxdrFZ6+MNzzH5vDQDclhVbA"
    "p7hT1UOX32R4UD/EhW8ZeurbcncFxEGuLhPy97926sJkiJOzjF0VuWqUUmymocvrJkkZYxdK7i3M2NUZbYkAY1eRRCnstS7a"
    "zr6WdBRw293dImyeR3f5ES9Vzzz9/lAooeifdFU5e0keKPUzL106oBuz6L1xGpy/3DVWzW0WPI7kfhGBlACiDRkFZ7nkH1sY"
    "wwVztFjb3n2X11cRlnlcBtj4mu80sgXzOQ0XmFdVlFXjIMMUiaqU+1EkiTsHjquvwc5tW99Vb8F2XWJSC4pJ4D1ciX3UvTvr"
    "T1yEcrzVEUEhi1gx3+a4UszvJycvgcE8vgcw49M1+7/vTyE9zei63wAjCyhKaONMKsbyXL59e1UoC0ERqRv8Zi7IUywunp5C"
    "5cDZGMGnRFxe6aKLN2NgcoM3c11AsqchfdsV3DPs7bnFlKF0QILuVvsF1b8nWzQqikCdSti9mi7li4q0PENlrXyENjYc4eL6"
    "BgwhlxhYV15K+jmjpNry1viOq6rYEdPJAmAfM4VWUs7EQUggsQEDaPemeEpvk3bE1mYqQiUPpN1HWZ7zecnQtueFlsQCatSo"
    "QVLWDzO2rIbJiZB4gDr+FStWzK+BhgG6oPMwo7S2vByhZOzuxxt4B02q68yXRvLO52M34YaNK2m8wyh/UGp01j2zW0QwOXL5"
    "Rdyx4rZ9ohs3bpHvFjDcUYUJn5qVzNioEj1i8yj51It+WRkvmhhjwc3XfvwiakIVaKf9BjLdWlLNBv6zSICda3TmNaiN8yeK"
    "fQHIGWeaeNtuPS+rFfgboFeNY2I+1qR9A/7ubqr4eeBTrkWp4uNYulGv9kfhQPVXUfzhcjrLPcv3nlBdbndRC1xGqc2sHArI"
    "l9vP2UjlxKDDz+5iZG3I6O/Ir/6iEZdEr7TAz4e/qAq26GQpglrxqVBmGWhFBSg0jsqM4NvB9VzwirxcDjke/WcfSeW3skJT"
    "aCxlnavZskJ8nhv9Vl3soCHTyaWKWvkz/Y/ccPrbG+kfwLCloT40a4Hz4bQOQQhDXSZZr6hkobB96sUVQ8IMc1EoK2Pwzyrk"
    "GCbUfosKriedFBiVmawEXiHrAzMzd8f5YC81STcTSXHsu0H3DYQTPQF22IXj1h9Hf2lf0DyI5BzpSJ+7hbG/wrjXWPOwq2Rr"
    "rpu0jnCyv3Nr0FAnEE6g6Ak4rrV3i+XlMWzdPQcf8ZX9DIiLfHXU+PUVqnxjuS+uHsElxDy7EJRdpb/zDDr8ybSpL7J6yYFa"
    "xCb8AF/BMzcB2Jkg1i1VwvQeqRc0LNfQcJsLGxlDJGHbdtJx16hK8xeao1TPuoTE1R3Gmm8U44LHjVl5yiTyTzH4XnF3ULUL"
    "Xbjun6zQfAhk0WJIfAu2qSS2aAAtiYKi5EommxO0ctpBRs27utdFp134h/tOzY3OzfUjt8njrDSctMR/PiFKat7lbG3TJXA1"
    "gM57wbxwa7rs5BTWq36ZcLK80HAqFFbRCqsxdJhmaNDTCg4wllNEAe7QKs0GZxohNULNbK5tSugr0IIAmHClI5KYCZf8Gw21"
    "k5dvrlmDdSxNn/kzO+HcbEjazYUCOMF2VGzwECYzUxpeYh7K2+1wttOgePSBVCb786EH83oGN8bMTOav512+E+BVc3ybEvPl"
    "OEhx4xpZ4ppf7egJLbQW0wgn0u2ZCmiStUi7Kevn9qwspLppnDRrfyEdY5n2hjDpOC9KssYBlbcJBEQXGT13eUO4P9yD0Go0"
    "xVJUMpyP4m9BDEuckKGPWrLjCb7AX9CEKBKvvhmzyMrg3px2AdH31g8Feulz/qm2fNK+NKE5fVcLWkRaMhRYHffaxgyhQhgO"
    "KvSQ6x4CTWT75bOf3sh4x1faI6yioEDNvajVvNg7WIfJVTGijl3KdBndspD2DqucFv6/hC1CNnTVN82HGEpqTduq9Rn9g/zC"
    "WO8itbsHyzvbQU9uxjkhamDizrSa+dq1WYvQ3cPC/qR0NkKJzyL4ITgW1i38Hto0Dr4puBmBSyM1aSghxUWUqamO55VZBF7F"
    "NqdJ6bYUVn9pJidNa5VyB1Bth1beG+HzfDkgpviB5HShdEzy+DTWl1q1RiTRY6oE1SV/zHMTm2tcxVkfIHjEpt+GoBMsu5Fs"
    "x5f7vjL4oivU183q/IMWftaRy6bGpFyeD/B9Abf6T8+BVY1pGi+C180IfDIH3uRJgOPN+qbCKvYeuaFS+LOHfnRExn+4IkCI"
    "ItMOeOgvYB3pktKwUPcvNn7VX/g4LGOEnmlbnM9JcbzoRsNqXTZ4YRpJoV0S4lEXi7Cg/phglgEmyMfvVbDiIctZvl0ynFbU"
    "is5FXPiJQ2v2eSLgIDow/RW/K4+Z6lWJtxHRa/5zY93kd/ibu6GUwCB+0UwVsjQhQGqowRpUsFBR1eWWUWXwqvrhqNYlNWO9"
    "+H6xrtOFlso+MUxjZJB5z/gen+RleRGNAseGtZ9N2QZrGG3E63Hfj8RQVbbwYes6KETux4lvUuwCAJ1/0F0UNOOi+iqEEQuK"
    "RdXHI5wSWb6qmr/1NZlU3d1pPqGDaqrVmJBDWupx5Xo7otRU37oTcGoaSvqafwfD7qeCat8bsBOovtzUlW0sbAuZlfQPEFr+"
    "Y73ty2/WrjH+ey5aUpLbCx38Dh6tqqlMnbrlw75AGzQfGR//jHLSatKP7seO7S/A/uRovX37xgD9c1wiZJXM893q1SsKU1LZ"
    "IPo5WPwsdvfp09g67O8eXpNmzZoeRNrEQOPfYnJaTjM2eck77AXXzdYd1Z2vrT8ua0qFuoXgtqkxFy5uhcys4sv4+N7o0PiC"
    "fhQ/dOxY6z+7WvChS5cac8HvKDmVvw1UDHrw1ZHoydYfQ//1R6tXr+7MUIk67fRz/dOnT+f+/edgHTZv2dKNPj/eH9dqWDSF"
    "vnpREG8WX3wuiMoazzWbshG6EkviZDsqJB2x4GC+tVwGelR7BjdroLS1taY353D8gArPO4/hEY6m/0qZFt9aIwxidZVC5fm1"
    "Xdrv0bckxMRtJp+SVNujIgbDnvC92RKTJasd+iBQ9kkzlQxwTSizIbiz7RLiL2w3SgcRrzYNQI/hTsFuURSlfYKQV+aRmVrK"
    "KCtzVse2uIw3FGNmvfSIfv5f9FIM/NlVIy9NY5Fq/i4t6jgELPh+TxvWcry9eg+pm7SYKXZVtpH/KX7kqSwG4odiPWWQnP59"
    "aVPcJx3IZcnUThkgfukymQyDvXItVqGlnSzra7vPwe9RdKKs9j0wFJDwXuwwVpNoMotVIV0yyFcs988tE6bhoTFHWEaNw6O6"
    "n/j9F6xWfTxCQrqoI0r3u13VTfNroT3UUePPZ1+JMep4b4auA+lBgMt+9dVRNOj+a+142bWiUYJ9XtbYmmbqOlA7+oewv3x4"
    "rdmhHb/Udr6Cc8v96xXasTzSJDfc4IwRJCl90uEwZY2VOQUp/cRWmCk46d3XgoO/sarX4XVbrllZYVswMhIkkQbtt1UYHjV1"
    "4fO1fb6nbmbckhV0kWXOOl0YlS1Rp7sgclnyYrwna4wQ1y1wGh4UkjfvLWVLFEJcJpaMN/XDnf1XLi3DcaUkIxClHtqUh4rI"
    "hMSM4WZ54bMqTNF9nLbVFfqtqj5ydcE61ZUZrKbzKsxB45Y5Su4gMbQnH5HmbwVyzaSqCT2BfCi7JNleeZrt8Y3UeswBDUnk"
    "twyXjKB9a0qhy1jcu/3EYluGKnVjig09R7+2eRF1bwxQriaI76rf6G+h2l2n9NfU0fzfRRgnRuWxSyagwPiclu1khEP9+MFp"
    "sAV9mnLCjHANWqF+l0TmvvsJeEIzYgLYBbpxv8IWlZdFK9kdVdvssnILmhqNXLpmchd6X5HHpGeLC4vSGhFJVlkiRjk2YjSK"
    "642IeLtqEY90s+qL188w6FUSdPIR8ybQ6lGaluCzmvRcuovSw93cIeuC4vGL0ZDiwi1Hc4PXa9dOxwUNnzZNKxvhL3TrP2l4"
    "JIAhimAp3np0nzrKAnAfK7IF4BhN3Aq6mZrTl3ia9COtKMF44ebU5qNISVpAcb+kYJUHdig/KP4vP3zTW01dBwzo7q7WiZ6s"
    "wSri3z/RnqkMRjOtWvCzEAU3NTyW6wlnE5n84mdMTiYztNPnCPo+0gyZlhENGzYsbphD5Vu1amXMHXouvJLagfd24O+0zzrr"
    "VSblUDEPOpVsf7yP6gwfzF71cZcpvyFubHpaE+btaXEd5Whgev0tm5CQefUke/RdOWga6viqd+oFtvJ8QyjZO9uT7b7AZj9o"
    "CKU65rixw3fZoqsR8L5/zsa52bAmfiG7etnU+uSjjz4//o03GwuDybZrF+PFTLMgbdvYWWdhES7tVl8denRqhWR1ML8zfOmx"
    "nQuHNVd+kIpabPCiQGMPsULa0Xk9PllyOB4cmD4bmQ0npcMwz36w1WKuN2APN4VDKliYr6vrerhtroMA7iBuPL1ZwOVAeW4E"
    "T0JUPrcDUabcYKbn0Ot3/r5ML2CC97tveA9XLRde4S80ElJd0B1/A0XZ2ltcdxpKzpsx2DMf1lzjVk0tMn2XI3HKUvjuOIxm"
    "lnhHY1aUT7W2BZ9Aj+noD1kPtms2ooSH+OAqkOLBSmCQ83D1kw77xQrIr7eQT+3ojlX4LPHxF9qwY4SSi032Hsa9f7QD7oxo"
    "Wa5U3Q93O+AmydoPNBefda1Maw7v8Pme1ynXd31mTPRlrmU7dYz0d9qz8i26LuycN6e6a1ZKLyOO6YSQ0yaUBs+2T2xep3X/"
    "1VxPsneVDsIcDVDjww2ft3y/LJUO6S0M6KZvCXS7STB99PjpwJyS7y4cREUrS5vfQrI7cyXtJz4OcytiAHpWJrcZrr5k1ENy"
    "CD7/7TByQtwEGO1bfCP1WhLgzBwEAHsD8f6UoF52A2IXoou3rORFekG9VyBuEfZGSv/qXeq9Dg/moYGUVzjOgh1E6PcSzk4i"
    "6P8LyKrALBhEmunagRv9dSjtl99jyo6HwlLDFAHLKxRbvsKVdmcJOayH4kzILsdV03lXM24vzc/qf7VpikShXPP8g+7gwdfn"
    "jiJ6yPDQ21cIe/DZw+X2/EYRLsy1QJOVfIO7QS/UVWStWxNEtGCvfOumCY81fNRvjXVZY4oeOeenDV9+3Eb3G+f9dIKCWfCn"
    "SfVWRAlWiY+qCmmzZK7ZQlgT4bBTVZI38C47RvZdG3iJXN03CNCb/fIlt7OrsnxZyk/KJ0ZiXi8vrzHw2vV34asMTlUY3G4x"
    "MWMMSFqBfThp6BAwEh1d66l81QYIrYNrHY+0+Ac37I/g1yiULyYaDTA91OtjjuLjmBddUSneWprdVrHfiS2uksz6OCOZmdAj"
    "lV6uePHin6NVgyrEC8Oi+DS3MX5dOFztQr9MIRSSf4bmg6xI0Z1+oBHWIDLglSvfBO4pDGwvK9iVC8EFNWrnhcoo7eqtMVOf"
    "RYjXP9TYN1ncz1ljhuk9eZM6ByFBfTLOOscaKOiHWVJPzMZNGFr5ZWgeJul9fuNK7mUtQPmrQHEiLiJVxj+CUSrxCe/6GjSa"
    "OHSG3DfJ/BzJu4vw1GkKAmwPl+huLgFm44EzapwxgV8eSMtreZYrhlyNiHtyJTKItKD4mtLjjf60N26+6UakE/1RW/IDayn1"
    "FlSSts5z3mWH82e6TVGHXpEmpsIOrnGw8t3WfEk2i8N79bPDqDj4oV7jH8BeLU4tiDjYO37iYbA2os+YH8NyOsmbBAvi4OHh"
    "o+mQVesuOZ9219cCEEMb5JMp1Oq4UFilr0vnXVlqrmzdus3MWHJQNlLaTHXCGGhNdAvf05p+OJ4rqPns0qXLaCg+K+D0za3F"
    "hZKePn2KO0T6e9rfBqCT5qL+zbiWHIX05mF+VlE1Leh6fWXC5oPDhw8/FfzWxgutccPy2AJNc3FZbz49glV4oqJcHHqQwnp9"
    "HSJunOISjqkm5w7Uu7DjSGRkZJUBhMl+QB0yKEGxqHBDx1TsaGbooJoIYdixy5sfDUiFPJXrKi+L57qPhrluDOLrUcfpZvwQ"
    "dRbSfQxXIedce0MHov/hR0NHVK4OE7n6e2DHpd78mP6ArhOa6/FnOt+HdaDIcBTu1JtrRgmzwqPpuG9HoUzIS/aCbR5SbqZ+"
    "059/9EP3dAQ9ej2AX6JFgfNCtUvXFzTWlDiiziIE/eGYHdPYAziej9Wy8WU10A7Z/AYSSnBZfzEbMn8R5qVbmJQrphLd5m74"
    "vLf0SxSSSK/sxWhrV3iq3fbtPMwFhUfSimE/J9MQ1EDglocEYNnzTlSig7htWmA2qIgABX/Q44NAnDT+TvkGxuZl5+Z50Gjt"
    "8PhJywFsfeHSxToIACOCBj+8u0hM/csYEsTC8WNJFhKFYH2swHs6BYtdbFmDdqAYeLtew+6xoMi8TmlP5XqObF1aL2Y/8pjA"
    "dGR+LdzvLgYQaRo6Oz23G98vgjKmCu/JuG7fkWKSVgwjLmCloGceygsc7mclAKyG7oGtrY3Rt60pKSl7iI2llvHe5oDiuXGK"
    "UTv1zP1Dz+w/9FBYWRGCexQtWtSfxJrE2brgmrzgjmL5Fz36CasxjxXgE9xTiqaJQN0woXhtmHWKfM7P8zOTU3xD8DyO0oEU"
    "96Uy+u43J/Ar0i/2NaT0W8rUDTXp4eSP63L7TgjtzPb8ZPfYRY/BVp9ktVcqzKUT/sJPiZP5cEucLILr4mQXbMUTS9N0GB4H"
    "GQlcst4sgII9/ez3AUqwD6nlzZwEu+1WP+Ys2KeJ5snFi3/LEmFQJVF9Pya8iyZvTdzIcATq4hfhaO31Jm7Xo/QmvvJxehPN"
    "0k/1JvptP9KbOK7VtabbJT6vXLE53tMzuOFOQtkY7zn1HWPzDbf4pWDPOL9yJOqeSrAr2ntdsCcdnt/DLbdg3+eXW6BeLEAd"
    "9+fMmbPsMIWwbpt06ViRNtDSBvlZj6aYoYNhnG+dsQMBFHHGDozEZRg7ENdqy91hNXZgqDXd2IHi5I6hww3f4TJDBymPvbQO"
    "c2OKsURgx+u9e/eeFev/Yq7HP5HPuWOnly7YU0798HFDFx0V0UiqHivjYAuC3BrESd9MHMyMioqq4i5//14cnNuwYcP60vrv"
    "1b/pCfxYf1dey4iKKG1ERcw1zoGvsPG7xE3WamTQeNnfb1w/QMdGs/HbPA2NHDeaiRXoKPQPvq2Hpzicvm2jsXGgkgEZszbY"
    "CRXh6YyKWOT8Fn5ybtL2fE4h1GYTI8c8XcD8082cNHnkevuOP2ve+FEe49m/et1He9UxwfkB7+dq7nFq7pHzLVrOp1lxcBAH"
    "gs+3EXIeqX/T4+Pj31aSn6sRB5Pz588fzHJ/7q7cEwzz7dMCxvk2yPgaB1P8RgBxdkQ1EshwfR787cb37eiINoqst8ZGEjVe"
    "C0bn39g/8dV/3uDzzd5eC8kZ51uUxXm+DXQe8DF/0nyikDibKt13Thn9p5vnhsmjofMEe+DcfOzcfEjNi5/Koyn7V2/jbzf3"
    "qHi0BuBpEvPtaHRLBRyllbDGhVvHqd9+yLXAaZ4Z5G74/vDCmgANtJzfGmx4cnLyVVJcux59DK8iBFH6t3Ce3YPTQazoM5jD"
    "+tnBeisb4kpxBelCFrzaLjyubioIZCrWefbGWX1l1YRwmdznINYWQ2ZOYlnmgiCJxB+HLELFNdYNsz3u4f5WHA3qJhisEoxi"
    "rZYtW1btKGjVjiQnCqqmvp0oNlZQKq7vi+/++rJTc9EFobjyD2MK48KfNBIcBPoM/ADRB5pPpUR+rhTlDA9jHjEOfKHCCW2/"
    "T5UqudA3f61R4gnPdD+E9nKjLFq7t8CKRl5FZi7dfXS7coY08Y8OC9ZL+2aZjOLyvcEO+QZdur67nabz1xr6/drkdpMF63hn"
    "YgaAHAo5eVKW1HYWYNdt9uAXxL7R1ZifZHZzczOT9gPR7E812IARYrL20VXYvuo2QjUddqCWVKgpsdUuXrtGPtFCk41aLH1L"
    "YEMwrPIj5JtwS9P9Bt6Z4rYJGzQO1f58x6Tvf5Cwe36d8jMp6In8l6bPndZcOZmRpHMfqXhTk4XHEOlwa+1IY66BuWRNDX7a"
    "d0IlQgL3F4rpaHj1ZycbunXrtgZPJPQlDh6fPHny0Z9/WJ7co6DIEIjlInqs8DCbP5ZQSZHWUkyBJcdoyKVF/2rTlo1Hjmoa"
    "tuc/aa6nsPHof8d1Dc3KVkXnGMwtlQnBBrSvJYqrtaTPKsmFU8uWz6gVUrpcof9sz4l64vhG63E6/nJP2l1xvPkv3PM/6tln"
    "UFbaca3/jW9fVDdm/a3/34XJqDyUaaiU06/+5R+oLI7B9x2Ar/go3uPl/8gP3Ow2swFCp/pQsQo/YiM+58d5VY1g0d89eW8u"
    "alI74OxHSF5eMh3mhj6HnFt2SKjIymzH4BntYK6C989/lK7XdzYiFiFFZMsr644V+XmrODJBsV+J+Mq/v4VsB8UWLlpA+QIF"
    "+G51tRYxiMl0tUVufP05+jNzyxuEH6NU/ARyHd3Nyyyad+Q8hnnNbU9aserjPCUpXYuVVziEEKMeFo1R+wdOa8EawHIzOxf5"
    "s54x69XxQPbox7L/Yz2ULxlW4OKtW9dEai2BX58LLL/ARVcnHKG0zzGmXYDQkYMEnxZX+meupbAhgr7dDxnBgIR7ynNUn0Pv"
    "yKs23IMbYerR+QbwnjmsThmztl3xSRk5fnwg2gFlEuCAKz8JiYVbebllMPEcvC6GJkIqZNZmwkPzhTAa7JBSnk6+fgEPg8iM"
    "qJYOx9zJnmhrh5XCoBhuhW5cKHxK8L7osVI6DELtkNvm1gZSVS+TQD4p0QqJFSyG1PJGQMk2UdMVhmIY4by3VPHxbp4UYLoH"
    "J6USM7QWMGNLIgawhUpMYmnV+gTF3L18ymzIgzP7oKsyIoq8FAF8eZ/V0yl/RhkYHbiGYGuuWRjDM/iLDEZDVmYO87mdn17m"
    "t1rKAZexmp5N5S9fF9U6OqHCkVlL08Rr46tzdNVU85JvNWQ+dQTRHvKTSXVsIV/3YTdNmycF5k6Art6TtVWCOXd8ynJ1JJfP"
    "1UFvWHXsJ4/rUf0qayoQLGSFwYhoRj7C0QarYgDN21YGM4P0w5QKeoeZwNixwfoAeVIm+3F33RTJf5YLJVvdvhOipPE69X/4"
    "7zQzP1QsaYp0tkzB/UuDfzQ0JtU3Ar2W0f+RxjdEdVCqhJOz5UMnK93gbLG3x300jy4FLhpAR/K1HPn/ejNTchg8vNv47xv7"
    "Ts4WW8e+40mUe4yK8YwTGZ0xAMXjKDwbmCROL5ppgRdHaflBsexUOv3c+mgbTKfTntwWvFVUnBbMhA6FxSlrPdSkThkVLy9+"
    "V9iSITZbOJ+QQzUYdpeYmGINDcFjhB9PxfedIQxmC9qs02gC/Kjn2IgOO8pGzzi9g2Lk40DrcODD8GdxqI6t+EgL6F/R0eYW"
    "v1w2ZFdQHS06iCirj9Zhwth2an69g6prTGeGDq4gPfF36mA+FubcQbCWP+3gE9qqzEy3eD7Dg6KjyxvBoNWlW2eqjvFAXNrH"
    "+H4zNEoAkrwT6Z0rqEK+BL3PVtEQYJF9MpG3SJaxj2J0FOk29F3gu1UVu6EvXcAd9vO3kKH6vuFm5CMPTLVaF6v6piCE9tOr"
    "3AIvrvf5cgsYNYTFTO9TwZgCxj73R7LOnKGPIgvxeZz7kJoKLUljH3MrQYPj1CePf6qPLxybzvWDVTZs7/cdh9Zqywk14+CI"
    "CU3yr+IIsShOEkPFSQZsESfT0qAtnfQcBk+P0YkZo2p4wkpnyhPMMf+KVorLSZjB18kQ4Q8pFRPTi0T3XBURc1jIjo1STglq"
    "wkUXpybtgoZmejGnJuw36c3dRKmmNVtxtettsNZsUYK/5HV6kybbZb1pOS2+UTZZuSynJpvg3HS96NRklVGkW/R1MM4Gr0xc"
    "tGsokwLR0ZHmi4YUPtyve+K7yi6ngxSH0mQ9Yc7VIZn5DB3JBXN1CM+WsYOy1LQOnKwv8ho6liaJlEGtY0p/kbmld5hQCbvj"
    "oXcQqSt8ZuggioWcHEOHWam7qoOVzMjVwUbn7pCjr3fI8Td0iDcw1DCTXfntWfnouzUet6AXWiv+B1Qi/mbIntbnCNgjXVOQ"
    "4d0rGcZXFYCoA7C7vvBjbYPj9UQW6g44WoSmvukxrOI70ulAU1cMBX/kgBy+FO4EMtb9ag683iqyldx1D2iXuWtG1pUgqpDz"
    "Uqcl91fpWL3UjQlLePNt5rOPfrSSjor4qiuo3Pag3R6Ho7faDVPd9mjFKxCCXvciMbzhgeZGJ9xNvDSgRnecwuIG0I/aTQ/d"
    "oz+u/UotFIQh5eKaB7QCmdGhfFfJHpHf3GCfyGQiMjkrQbsy6vIVrKVSvhEZHp/s5Xp3zpVVWnIrC6ng7AEt22toDYMDtL9w"
    "gOZcmC0+ZtYzG+EQev/cNxp39BuF5dSwr+zXae5LySaIWVF2Gp5yaGpmeHpmaI5cmn7QtImm1wrsGnxJCABZOtCMkv4kKbaK"
    "IBdzW67SPqIMMHxBt6lHZeWjAX1rthEHhV7PK5RTLqF1WAcJjtbXV6igFZtJLs89htB9QxGZHM9lvmsrHJMMd1n8MvPnRaKA"
    "0y7+dUuMo3GWiDANHAi/yonWZvl5Lm7td34eYSwfXr6GjyET/NM2YSp0n/MRP9nZDyneK8YhbjBfDoygk+IOGBAHl5evfwPW"
    "CPHhR/X5hzfUqxVEQzJXjY08uavIRWU4amynEmYnSFbqZJNTEHyrD7YOxcRMPoXP0a+R0pNwJq7TWh6YNKu1wrmsuq1aYStw"
    "W6bg09Wrt2gwWhqukNlXu17auZVVhQq+PCQkv1lTyBcxo3r+11qooetVWlR8qlpA7kg9PPl1qm/uSD0ynzsrrgl1qeNh//79"
    "h+4mI2yLwEKJrQHlabxF7xDUDlUNHTTN3zd0nNS8g9RRmFIF79KXZly7du2umDWLc93HzrxOHfYpZnGn6YcPHz64clSzUKWR"
    "OxHH/Ec69jjbOSKSNf5rkuN5Dis5vg2ypvQ5yuW4Wyq+Dy7HY6qJSNZh2Cnl+K9wWMrx3+CgkOPmp/xdkhz/AD/D5Xj2UwGT"
    "7H7NClySkwT3CPU6lYX0+qbi3b5aPULJ8bDLRjle7olRjptRON6YMXSVjfwliEi7kEdCRbYTv47gRXrAd2iXPVr9KoR0R+ty"
    "HMVMG12Ok1jX5TiKnA66HEdcXEtdjiNRRHlNjuMNZLmSHB+e3/zOQeEWFHKc5Ke1slGOI0EPyXEuchypOhSVFajkg/Wkkg2Z"
    "OuVmfvG59JRZyn/4UbRBrA85Qnk02UqsWxblEuueW3OLddq8rcv7dPnqtRTr6CizEdy4Ior1dHevLNBYij8moUlQ1BEG8N9n"
    "RrHuilrHISexjirNOSexjle77CTW8WKXncQ6yuOzRrHuhm/3gFGsU07cIqNYJ7a9frpYd2uXLq4ixfqGb4Vf9OfcYj0pNJdY"
    "h1cC19ZmxYUsWVJGyy5irhVqBWB1Rae0Xn61NY8ePVqNgn5YOaYEfWwXfrKl36jzcM9M4akIrpzSCRfQzePgzp6TVngtrE24"
    "Fs4/PL/c1/DMm+Fn8iRw2U4fHgvp4XfRFPG6BwukoB/TNdrLGXz7apSHM0ZrtWjuiomZQSS73XRQ1lgyfbUmIgYv6M0m9Npl"
    "07PVacINYtNus5G9luyExb1SQlzIlp3Nf5uhXIRjhC98vN504RZmagGtSSi/5XrTxO/SHqnfRnPKt+KCXwa11jvAVlxJfo1u"
    "QZf8qRf7ueaW/Per55b8TwKp4wqX/KOo3A1sMIBvy2LPayMa9yAloBs6iIuprN7hhXM8jnBev3l4eAT13CNAxLkCVy2cO1K7"
    "Ot/YndLy1h8vXboUMZL33WXHDgmLo0HRLntSZolpHciojfn/+o3hfdgqGDqqOIjbxvAspOy13KMHsIrcE7tuRN8FxKbAOpJg"
    "uRLMXBLgVL/JGXz5lON/wliLeTGM6/JPRopIejN0C9yZgTLJp/P6t1hyx6OAP18uXJYWGwDpVVHvsgUHvATbrVe00RTY8hIc"
    "jz8X/tEgLUxctMOMjfMGSiwqMXyR+on7g+cxPQ/XVwzKiyWDv3spHMdLJat5Ja6MPhWYf/J4lG3dup7QYu911FxEpcgVm7ln"
    "iHR1lJVJCI5zghTeu+tmQW5gU15f7xYLUXQ59AR8H7xE94i7Dx8IZg4kxxjmwu/G2t/CXKs8ISKnL0l3v01fdoE/0FeamDlE"
    "zqhW2+7xKZdwfJSW1OBd2SnH37VCj9FtdPAta3pe2MFpM3xlVo3OlfGytuY+16gYi3JxhxLMun5ox69jpV5LwEPC2oajUMzy"
    "IWYVSShSc9Xatct8xArfZCQS86SE7Ufjq+i5O6qS1IulLdV2NEK7n9SNEg4Q/Z1WEvVFXRWRbrRQepNzdOuFFZ2R8oecEaJS"
    "3ubyPDs7Xfp1fZLJz4RoBpHoJeI+AyVe4sTCiZtISbCHMF9n5k58Zte5uqhPlpbru8tO40RPPrXUsOGaIuoXlI/6roh4Tui/"
    "TQ11n+XLb8Lb5cs/I5iO5L3/n53MJS2gWIzh6DnVCUznTPzY/io/UEW9zf/dq+VrRjhlb/7fbHHlII1sdlNlp9BmdEkj96CM"
    "W/6BhrHiH3uiLiLLJwFU7uPZCem5J6aaqsZp9P/nnve4iZMi83M/mYAq8DsT2uVQbsRPcOifOnlApuc5WLUaYkuamjpgUGMu"
    "FrgUiSvI6p7LhMQ9JFJdCLYe8mnMaPFCQvGsP6jCE1gcou0ALccYral2/7VmP+mKYwxrtbapCaoaD3LHFnfnj/MEb94rnYqN"
    "4aaztIa5ESZxbGVsgCBpor0BmWE+VKGjDPFkTbY8cID97s81tcH3r6z8AIWjo6sqcH9ePunzuqYbyNmQ++aAp3ROa1nR5//f"
    "2ONiV8yrlMSKZs4r3UVkSiMUCSql8cKkaiwC0cSS8Ss3IV1bU5J8M1ZMbCY3V4icX0ypbG2sBRRL2kfNtzoCTW6epeYfRI3k"
    "6c5phqx1U+G6Sm1sPIFeV/UJPYZCCqpax2BVqB1dx/nt0IadwCpvAzAJeiRSn+/GXP/CDqjvn00z5xzM7wbp3mR1PNqE04Ic"
    "TVaZrcktySyRvTPSQWRShWJihsn78P44JqYo1peYrGOI2rsmaKxzx7nl5UV+RkqHDbFTSc9WirJrACnyzCNZFDXkdwaZfgL0"
    "b88vqpvtEKRVZHe/rzJocDLvpkyknLwqjyDb3yNVM5+QdrZbK5113o8vg59X8EmuRmwHn/V8nA9qtDFgcITjhKaFYA91cijo"
    "PIKMteWKWabYrlH66/QBlirR0UWqODEOoHn9hFCqqmCPZxqZNOh8SpdKSRtKjBRFNNrpf5fqydxRJ18l3HBvJds+Rp8SXDWo"
    "Q2fFetBE2fQZuEw9U0HUwyIHsbg4gkuemSXsRLgTukj6etQ7ssWr9kEn6GxR8uQ3A+XEXazKKvLQmHQwQ/nxErwjSAEQrDLp"
    "HBiL9CAX2COHxIDoiD0SOzrpWaDktTKEb0mMGNlLmWJYdxiZvvMil6FNUi5UmdBVnXTpARkW+dSbKiHLalAE+jgmu+dAB1Ms"
    "VPK08SG/BlP5+5oahcDgdbB5Oub7QaqZjYM7V5O2O7Ygt14LsMOP7fgPrnMhm0dznLNcsTMlYn7uTwKn+iuyObxjTc7DPEbG"
    "jNFT3Ew9YmLKhIKxTBqClIejs+CQ03O9gxaaTriLyW3BZJ9zQTD76oG8JMBfitFrSpO0LzMlEcdndSLV60HmUGGggkTedjSM"
    "cR/I8G4p185dFHGU8dJuvHRtbEFxTwGuH9fzF4mqL8Yk+dqtfBve3BaeLSoWiU42octtVDhNjJ+UBlHuAJ3haZIE7ZJO54Ym"
    "9yXl0yiiIaTHyqzqZKGVtsmClwVlgg+GZyOioys4+e9cq0dH54vP7arASbkehe9OY44fStU5P2o0TxKZQ/mcKKIchmxECmdX"
    "Ihc/GhyT9u99TwY/ctzzSyBWEQfm8wpe0WvCvf+NyLDGJMh7gnp0v5i6hNAaT2OPmyFmNcezAJrap4k0FMUyxejDPhQzObSf"
    "JH0lJ1Rz/vy3+YsdiK89kY+NJ+4aU/gTjeZvaNchxa2DK/MlJgNz0ZWVqODakljvGPOXRVoGavmANF+lxl9Lkzi0ALuIGyEb"
    "rKhIB0PhnqZz7JtShENKQdp+0f3E2fm0L5PsuwOzKMEVfa58A30TibwDE0bhvtRnQvMoK9Lo8Cu+x2aCrUbIW8QQuV+D279B"
    "HGpXVXGo3lV+amHaB/ERTysulJqkJDhhIQ9/r+44wgUTccdaB9mVVlNB6TwP4HDgpzExMoe+UUzMSI/C/ElyyENXntubL3yJ"
    "nPgKN0NdLxB5GjMfEXc/FWRJ1+J8vK1Vo3K0Ehz4sq9f1+Y0Mx/T/FIyNJOeq2DHXCNWnT8DOUyvaQGtTeLvFY0Z7m2v+Zyx"
    "C5MyjO+hjsbILf8Q34ppN0kPt4uShxU3ztt84yiDYrolK8rlvLW6UglfBH7FX6tQxEybiVanHOpn6srFecOP5cVp9SpE3y8x"
    "HjJHC/WyUNQ44rnc8bglq0QwE+HqycisiX+dECa8YkoVmisM8sLJ8i9ppyPq4X4H9N0GGRHsMmSs5pGG8Df8Jf31HY0/3qD/"
    "U9dhJ+Eg6mFklDZ0dZLfd0YPY4VoYNLJWh/hV4/h5pSjrAxanXe9ya96U8D6CuEebKvJvOlxiGTDtF+xDlWlpI6GKpBy0U2L"
    "Jz/yR0gw1xQEXMVyXIBP0GOpMd1GoHUf79ZmAvHKNZzQqR+k8CHgom645Rq6FBfBfTf+0PYq5ay00e+HI3vhFErNSLvGO7wK"
    "hOJGUkQmTZTTsjP0s2J2B+JcKsXEDJHKe9ComLFU/3CMlpNpLW3mCyM5WLniJBYS/Q0WLthTQwRHhq2SKLJBg4kU4QeZP1+p"
    "z7y1KFPbL5XUYKwAn6SPuXJwTXENSe44jZ/K+zk4aQ303fZIg1jP0QJU4siWeuP/tP1Yiwi4VouO1imfvHirQHfjlLBgxGSf"
    "F6pRx6UXZYDY4UiIC40DHx7npRmjLY881ZJwYBiJirBhHlKJbI2pGnXK1FBSRiFLbIwVbeTMpk9/yXQfrb0Gyp54tYbDcFIl"
    "GuIXMkBPuWS6e833Jagcn1zq02mTocuFVrgzjSbu0Fb23+yKkVQjJHzGCw9VV1X95UIhxOTvlPWxgx7DY3S8uByELBJ78ySL"
    "+vtSIFdOh2s4CwMeQnJps9lsGqJcZP20jMN2Bg/VeyrIoTHMPDVGmPjgCjD+LzYnTQM5gBM0f1B7LkTsGhlT2RQjHb0/CrLf"
    "1cynAjNPNI5lXAjZGu1iK7vRZ1gSBc9a7YXekMTTTDPxrW0EIjSMBTnxFASFOSea+Kcasw3yelZ38liFscXOvqg3CuCmpQT/"
    "saOZwuFvyBIZ1NoxlqRxZd3PS8K+t86mEw9OjOJeFBS94OEsz+N1Vxslp+iDyxpZwYntX5Sr0gaYeRJaRh9iUV5LH2QhqQ2u"
    "2bpk8K11zgzkskxhR2+UeZ7LW9fhDx1HndsZVS1LVqz4wcebxp//rFfdxH+6YWHyf/rnkgXe9D2FTd179+7p6tsIj8pCpwa7"
    "p6Qi8uH/vly16mvTZLlB/i/8e6NLlyaSGsnhpe6rKSWcb7KwzoPoqFlUDtJdVWkwVp1cxJN7JUqU8CklyZ7Y/+mTB5GRkYHq"
    "5q9oj6OKWse6fLGEjg9HHRXTr4XUeswPZS3fMZK7MCDjpZs0/EWiZTXlcTgjI849Ja+gx5tUYcLMktZQEdtNk3RsiChzcKPA"
    "MpMnaST9rYUJJvayxwbakXGG9N/gLEN53NWSDAqPGlTxlGkkUhrzcR8D879XvKHs7VwFxSSVA+I9Da4ATQxw4X5Ow3Y9NJSz"
    "HWOodBuQCZkBBk/KGHVejQ+9Fmc6g/aEksOp2XNKbd2x1kDpWNYhSWWYFgfN0X07VHfXgGnFqrzPXJ15vjrqzZBsg+NIGEQO"
    "nW6GqEoXMScynGRDnZKBTm4Q5s3l+1XDp9Hqq6s3SznklieP37kQM9DkttWSm7U3+8SA2hoPxtrI+H4lz5w41jjVVWY1walc"
    "Or7oREO1mb66KkevO8FJ4lNsMEpv+vb5eJBP1xUrVryHTq7ZYTVXojtpxl//0eGbczAbpfbsqN69e5fzaIACr7ryG4XJOnsR"
    "5X9ctUkGZUL+N/7N06kLvtGIAfJ+1H1F70OB96u3aw8h8MorjMHvijbtUHV1wsJKlGivUu6q/d8+KRUZiYrxoZrq5rXHaapO"
    "8nwlBB5KCRRK/mdgrcXrxMPPE1Z61PFgATX5am/Ugiwi848IFecf+45rwGBtz6bBi57+c3OyaxethWumYB0KuFSuWVWIHzPq"
    "wntRTTAJ1MtvbmQ4pn7D9/8tLh3Bvi6M5V2YA6NdwoSu7BfmXkORfKQ1Npx2mmY8xnvddt68q+du5/5891u3cx3Lv80d0INn"
    "f9L1J3/IipXyYJbf4Ygbc/mavIT5/CO/+GJGUUF18IDruqFnRJKXx0obDHL5dMaMKegdC0DHZwKuYX+0ze9Q3UxEH+0nKdD1"
    "9JULRVjeORefHulhYsfgxs/p8KF55DAfLmZ+Z+bGy8+nwWWXq3B34W9wuTd6r9bD5R6QMGGJAy67LcmCR0uQLNItVMnZ0CYf"
    "9YgWMiF0FeFN3gzkr9gf1dJM6e8YxEVUJ9dSp6j2SEiLFiVlEI/2IpcmY5ZeoWAIqzBXKVDNKYKWs282Oq6b5+O64tpAgWxt"
    "3kBIFQsCV5qjv/NIq3bbxN/IMmIvqGGaxP+1/hiVBTkkhAqVN8b6mUeFdyK0Dcyl3y289axjYhP0v6BFponfGbmW7Bd3omfF"
    "0Zgx5HGwtmPM57xYCOZmbduWUsJVc9UG1u5DtRppuhaaoLEi852rxQFDXdQA1hI118zNQ+oNFG30Hm7wU/ZbQCBIWJ+JUIoB"
    "bqj/TzAxy5fy74kALfZ4ivq+kupav8nr5V2HQYLYPgWTAZ6Su8lUvG5BDfG19Eex8fkpXjnjyfD9T3ZXwhNItUNSID9Z5lIs"
    "BUb5ESxuL6z0I9VhB6z1Q9+b1zOY6odv7h7YKnjlWKemQLIIDZhxyryzc+dP2qjPNJLA/YOGb4OP3guWjQ/RD5Uz0kQNrd4L"
    "NhwbR6y1Y6bLTFEjhnytbWfKIhzItT15poQ9BiAllLpOMHo0ZkrqCoThjZlJXNRYtw3gXbrOPaJieuzJG2mSZaMz2gwnyyAT"
    "2v0mmp1RiRx+luFTpxrh0uXBeTesmIui7a+2QxqG6+3qw9EofTXNItuqYNpBb+ZEeQ+TZPtIn2az0DJLCaL2WU9lSHWgNsXG"
    "fHByThffL0HYAJsq6pBGtMx2VVTucaRDV78n17IPWnYzqH3OXQahoYu4/t4ejT/D62eGOd/fbLo/668KiZ6HhfC5etM8GZNW"
    "EuYY6o8F1ZWkyuZPD8YdHmAmO+4JFlcKtsMHXKw48nUAK3+uoEBu+2ebFSFGLdbg7p1ArhW+XvcaHTZ5fkkD63pSIy0F1fdb"
    "yvfuVVUqOBPJOqYybjqe8lczBdXujxqCm8EQtkRkTpRJRy/VA2kClG/evJTJYeRPt2teJaFExeHa6zZ5chsKsPHdr4Edw5e1"
    "+B9lbVj2Rnig+6qiLuQQfu8QHxDHmXYa1UgZgzgr0Kiopvc234J+i/TTgmC4n1YZBotVjTUM+SYToUufji/Wnpw9HRqqFB4s"
    "WQo/IZVLFvn/W37xxRcNDjk7WE+BsaQly/Vb/NtM0nDfnTFjRj0CtmJqdCkUoetciZVnVKHm54SjbJzhrg7xkRmoIawOU1C5"
    "xTb0hzouvq8tp/z1jU/P5vxUUUFtu+sneX64f34Qnuzn6jZ6jMug17gL/9ERrK7MlAzdu0E2v148dK+OS78S/5XbfYjf9RY/"
    "GHUbrGsvUeA12JkxOvrXnRs8nfwQEf+gZS7bo1c5s2yFkJf44FfUcrmpP3sEUdI8njX5hmjt5i+gDN/4H1ErTno66e9welHA"
    "7RP6nZWC6GKDjMD1elV5CSMwHGbne2vJZGqhXZN18FfBd8dMB/Qdk9+Z+3w+IxIX1sqRICZz8eImluvw/HTq1MGGNkEbDIYT"
    "6Xzhf6ldpEGg3nafR3tUL9kOOq/MZ9F29kWFl8BpnTSt8WDxsXBy5qFBlpdAd+GLyV+l9mQIP6DNz+bU1qcvzfrw/drvyb0Y"
    "vkT7ewqUhX+sZrA/ASnDK6CMTJzcsN8JcX3B5aTfHyuoKsNvl8/n/X0K1rYc7vEcGVQE/K6uISA8bN/DDW1px3q0LsnWHoMx"
    "xVhXuM/agHXZss3gCORi7RA/Dhb0THQEMd/aURgNPvbJFQxGB0+4DtaNwgwsoJaJqdSH7VW5qxEE7rzaUbniEMqc/Y7AQk/x"
    "DuIGa3Jh3C2RUtw7G8P5l/hixNItfPZ952nQVy648rFPfyqOrViXTc+qWM2fje+nXmOnTatKGYr73212SryZCQqU+D1OqYbn"
    "+Rq3X+ggp5d7udKGtK7genowtsGP/IXazs8VO01LRXGejbG81ug3f7wVmb+SKzNLosDkEEnvMxe0TeJxJIjVtPJY7QXj/QxA"
    "P3sGPQFKpGXXnd7eKZwtL/epY/g8LY9BA4YQNobVatWqhVcIXneNC7NMF2gLChXF7yIikosWZlqkjd0l8j1WP4ri1Xath9KD"
    "LEUblNKf3j2QS/LoK1Y+ZqY3cH9bFAap+TY1j9/j6VOFd/LBz8kuw3UZByOV5m//U86Rri3aqJ6DyUNDYNpMLTSQKXbvp5N7"
    "cPUlyCEC6XmJcHdUnToFvlN3vmulxttYbw6eb5ozp41I6hN1Hf89Z+GZengF77rq+z3bi1Gqc8MmESmMvS8nAWZluEgXdlYp"
    "lbExNszLTQlGWQze4oJBzN0uLi4m1l/Hxl4SNLkyl8uoTCaykD79ML56tV+/fg2EU83ARP6/0kBcnqQyybfiwZk+359uzI5y"
    "GQhWGFAe96uufFqLjS0FBnSQOxz+qgsCNQYg8OotgaaCVtw+zffF/vlmTPdnHlao6/0K9vXfghXJaqDUisP4mrlIg8JSJerZ"
    "ozgzR9epwt8PRbj3oWOinPtDOXCo1g6jfWsSLaOo/XLbQjUk6qnctdCJFWUzbFpRqTJsggI6iovxpy4SFhSFkaAFgb6kN0aV"
    "QUlvFyDEKDaapkH2WaFL115y/PiiKNxWK4fXr19aAnCzPX/mi7sYN2zO4cXRIRb32YSjgjZjnnr/y3BiNdj/iq/V/WPULpc3"
    "3Akdjaab2cUFVSuvJdzosN/o4c6lTVIBVvCa/JrF4r6cxX9UObvYngadFe3hanvKRwj1qO+07WWyGjIpnSiSHXXEeXuK2gbK"
    "WUth+SiMMmWTCCJ+v6j3FfFKQ1L3onwoyvdsw3m7HLchzvfHzDFiRB/PUGZJlSmbTi4fmrepyGXKGxDgId3LXEq44/cnUhB+"
    "PmHeqpEGE8DMrTIFKIxKiNgf0Wp8XZYbjvu1i8WJCHznKyit7bfWamRILiVa1PZRJuhPJZTB2eIPJ4N/jt3bBE9sGQ5Ir8RP"
    "dvqWSIMpfhRl3QVbxId/hh1/PPHKQdT/j7CRW54/O5mUFf5iw1zuww4BstEKHQP2dRZqyAqVy00kOc6P/x0Hu9xMCWHAV9Rn"
    "pgwEo2T6Tn01Elhs+pcb3PLMDJfsF4vQ2IzJk8vY7JLLeHz/n2+7VS1n0tuRxxEqszZctrfKLPtbgbmMzbOuov1kesu15AKq"
    "Qu00bwXyG1xR5CWhOYcLemVFPRaIeJYThvtBqNjJ/3Qbjc2sOsoDDquDXr8tFWJ3lGcWC/M8djIkH0CZP/vPN8ce4VWhQjji"
    "K7PcUPHwHPH48XmxZ/nWqVMK99lEFEoZ/9yPkbR5+QUGerOqfIQyCpBaWlH8zL968+ZlKjBK8glrhL7yolUZ8u/6WYi+k7Fb"
    "8T0xq3EQXgpBSqebIFvcgH/wIyAbmvyYBU99vzm/lKIuprIVypklJrWXRDehHVHr4ePYxsaM/ug6NV2k4Gsr9fUu/4F/e1EO"
    "Qf0et5FVvRjN1yUUvHP8YGYuw0Y2zacpZIGBGq8JocBzFC+VdjJz8+ZNzZ3MJJOLi0XFlRxDVL7/vP/2yVMB+2TmLHJXMJeP"
    "SL7XjyVJnWwR+0JmC0GG+py/2uCx49oWFDJ5RR4lgUv88cT0xentdLIAkmvhyWb8lxyFWIyZxDWsMdHJRzmIJMMP93Dwl+6V"
    "YyvExthslblM1qNLMxGB8ZcbbtF16uSVDa+DFECjhsfv4tGxQQWh54m/Sf1FDYnU8+YxvZEaZmjAZT/ZSMY41T43eVEX1E1W"
    "meQd+JwVSC9xB8H36A64TL6NaLr7fE55oUzuy3LJZL9cMjbP/6Rtprmltafzjcj+ntampzjsrdqTZFO2x6qmaE/TmroMF02t"
    "fcWbObWzGhraZAaX19sjUb0S9RPF9ejyV/z1+yebYr+b1rb8QphJk3b/nidEugXK5Gc4+AEn+JcmebguXYne5/L/6D+vHHsJ"
    "PrGW8HGw/U//4y/yKb6/IeKthdO9Ff7v/MTnfuPneexom2P3vnUbfflcb8a3Gju3Mu/ak8HeNB+62blJ2sByGL7Oh3jtppBp"
    "4ork7/kwI7QBpGAI/8DfbvBNqwSLdrxCBOuvfJMqyPK06VOey2ZTuQENPIRteGIYKpJnfYugQZDWiPRq6Uk8KvgJUioTNDRx"
    "8hQCnf0+bDvhUeeIXAVUui+5MPNJLC2GfXmpMhNZMNysSTfzPhvOkgyBFcT0TLf/Rt9ISp5l7KFwVvd0YPqLGS1DZq5UWXpO"
    "CtegUD/uqgc9l7zhI7AvhFk+u8slxa4iIuwZf0YKi8D1MsE5WGjFWualOjkm+h0zGnwsykpsaPL+LUKcV1POXSrofZC/gcK4"
    "nhpWU2kbAQ4Fokdv85hqoJyLr5V6h5GphdRP1tpLlfm14/9iP2oUb0gC8iWeVUOi9BzDPI+dqL019rfaOM+z0/laL8pPfvYu"
    "nw1D8lEu9hFYnI9IOH6DpX888c1xRCNGdSGfy9xSLd+3lYydxUXhlm1dSLM3J1NVdiFE84lxRxGbJwtxMXLkN5xDORTCKTYa"
    "GyjIMLfji3+5wecd4XPypiH4Wkw45lFD8M7jRHtsaXWaC/JHy/KICQazpd/oqKfzxIJNsn13bLttBDP2o/ZziyLya0Btyiyh"
    "PIzR1UDjz0Nn2ffUFkoXWvE//Kfb+OLTyyoiOMenzDx635PfR5jQMHNcd8D3LMQBHVgXsAV0hGx3zG9o2x2FmjkHupTGMFQt"
    "zMS5CHHfP0VvZ77tKZC8LY8WVRQaV8nuvcsrn9oEEkppC7CtR282e4iklUsfEjDvIwKdOgqL7LFdjD2hHHZKicjwNCnw3xeE"
    "sVOom9nkzr2BBRqIFAYSXMgoriSylf6f5q4FvKYrC597b96JkLcIISEjVa3neF5FFO3Us9oqol6pV2c0nyKqqaGUerWlSnVa"
    "9OGRTo2PxjOhaBDFh1Q8IhqPxCsSkkgkufeePXuttfc+J8b4tN/0++Z+yDmSnHvu2Xuvvdb61/+vFA2lDu8u/+CmKFKfINEM"
    "IncPSOMBW8l+5RlYGv3JavISArtGGyn3Xhsu8Le9vXOK9QEsJwXyhUmYyqAoNN1T8wTrcn6MTzfMOP8FJzGWZXmWooAA4Ab3"
    "vKUqQh6yy6myGn2/kMOqav81LKc5oL6PsHQo0O7LvCTd4zJlKmBSeZRgPbgvuJi/xHt1ShF8NWolTssuA+CaRJUJ3UbozcB/"
    "XuSfoShtplFZVccu8wOeBzKe3XVld1vwGx1lLlYWzg++BOx5mj8u/V1sLQHVW9l6fxDu8ylgsxX2zA8+vgst5OFncJYoVNsr"
    "6wzVOPnZ7VGad+eJfcIp0X/2Bfgojncxvq9ySl4AIsvfTQZkuSx0rvCoISn8kozIAVmeDSd+ZmS5lkCWP58rciyAgyXByXc1"
    "kOXziCxf8ppL/B1i3sJJ0/Rqpp+Pk3i4d4uA3wCbN50+fZwprCKLEyyyeuBkZGtTYXoVfSCcseqvpGx3wAMB/SKJHicQelxZ"
    "H89PKvSYGrpPUOjx+yZ0GD7bpoeix+0UekzfH6PQY/r9gx4SPRYN43fFPxw9nk/3lypOD/kLtHwk2P9b89wN9Dy4S8TvQt8f"
    "RO9tk5KT3zTVA2pBX148MnZFZhewCCVAlG0GYe4QBBtdnpq1lA0bypxW2LqHtQc0uhmAjRdY8fZCMBMts1n1ymK0FyFeNWFM"
    "fO05Cwqj1qdHDI+xWNvZ4UlGYjXIvgG4y3gIfY8K9BAArbq6wAQjVvNJGnQVz/JFjd4yCSNulvJHUZpTsKvoLJeiGYTeooAU"
    "o/OtOPo2ngFFrurHLXeFR7JLiEbQmfsC/v/FyW9Jb8XSuLHlsWDSh501TJo+Ca26JbpbgJGP9f6Ev4d+JsGN2+xCPy1cdDFk"
    "/yC47YuacNwTMKlK5/ScKODCCZJ7hNgqwYWlFsVAabBX6Z71UXDhXsXSpO8fNsGZkIUl0iKqCTaYJPNLvqcMuLB0VveRBwQ8"
    "uOYBuDA8S9QbbRNwofcyvk3ouYNMcGlDHvD+Fnj1oecI10aYajYnJyeP17gH1nH1oQ6BUHLHXuJfjg3q5hcI0v6aRn7WA1+4"
    "z9WOUlzcgwnoGAPeVotTOru9kFw4VkYdYysrsuDgWHcrMcleleKrDeRBxOMe8GlRUttsyzQbJb7ybD1TcvXSSPQ63kOr3d7k"
    "Mclj540bufXwuDyxrqxeJDxCHA82HT/7vz0GD+iepKJFfXsuZ90Tmu8ttnMHuxPRhTlCtS6DA2pdZWU73gjTtHrzubt/K9a3"
    "SR2tyTU2bygrnDa1ig21JHFTUTgDFkOIKH+2RL/8xnMEvndEtorja/7RevBB1MESnKkNnMLz4dbn88HI8DVygNssn4gIK4bh"
    "OR/2w3047CghOSlgVnzH7sVHeIesc50+gD2kug8e/jK8MV8ul0K5G7K/Z/PJSP+aKh/zNe4A9d4PHsq1bylf5hbVykh3hMY1"
    "lyUTsf+CCNKVNQwu+NwdeYH9floEasZ+j8qN32EFYB6/32evQptPcOJ+hpXvFRrqSxFTZoKQsA8S1u/KR51gYoRkKOkupJK3"
    "XiSUqM6KnF79kVghNyIgKgoh2QBwoj7jT7dyvFUoTY3BFXpuw354jtWB3nsMGgx3bayDjoDn7by4XjAT3Rp1bS4ysvXXLiVD"
    "cd/4sjSbuTIPR+9E8Papmt+TX2IpZrIWsrKz3TWtzaF7UAQU8n3qpjBVi23/L0dBdvDhJtrt9VbL20xfpwLQuIWQ1F6/cOHA"
    "R1/FfNRG8Vq9+U2v81Vbd1k+9ArvidTWKrz99Wed0M1Ki/37rFmqu8Sn5iZiKxW/7REnbtiraiOitH8zUNoz2lJTPxDN1Gu0"
    "Qqs3JgE2wSMJCQk9Hvt9HnUCPu4eE5OBMAvlEBSuWDLbR7AB8IVl+U0uGXg0j+Xmbb/Gfy8m9NAhbrZWZQ6NQZ2uk2z2fx40"
    "QZ/oNJvtWcWDkfouHiLsY44f70CsEHFUd6TsQEp8IM6sYLs9VibI3bmrVi7hwVc2ijwHpLaH/84Tl0WAj8MXCw0AALCGQ5Z+"
    "iVULhmqG4TGY3NtaSZTfGWJNEf93Jv+JO6vCy7DWiNs7FcXYaL+WaUs7X2q30Sx48sdU3WuoyhUEYQHhH32O+CmajXA8b6+0"
    "K5C1OQ5mO9Fmd1BBI2zgrt3DRh0U3PmpNXbucdS3HXeSAjq3fcAjWj1vhmU3/3y9qWaxs2JaJ2UC02NNZtyLIPYSyyqD3QtY"
    "D20ehJpz2De2qzCNIp3lg7ASR/uBFZLSBfdDyjHgtZ1D+Q7MdeAW0NbezjqW+8TBUrqgUXClUERIRX2SdRTV1nXgQAEX5Wms"
    "FLsN0yobM+FZFNMAMH/TvbXkgNThi7zfUrUiuGlJLVTM0fbk8XmYZQrnmxktLuXD1booxUpgNpgQEqvW3amIM77cWa9oWM+h"
    "tJ1AuOKaOzIalyvljznk0hRBABwJbVf42FpzBbr+jqRiTqMDSw5y4WEEoMtMOHpvl22SosOmIiNZ6KNDcJbtzb1Kh6hms0Bp"
    "3oconSteidQfgfVSKiMEgeZaa5IKjVYqZFJZZYgpVNiiM6fg+I/LHKFp8/cHaXV/2jaAHYI8xCgtgW31qXAGD4BwfDNL4J53"
    "/FrXsYqgMleYNop9X5Qxgq2CeqQQp4sl1qly4bsdAPmTVKpznsjSNe1V/QQPzTvZcRRq27HU3rOTvRF/eiWeOL2R9c0dtz1+"
    "97H6HmrpZxM76W2QF1xGQ5DFbRr/0M0Aus0lgilrAiOcg1pCLNbnHtQPToEc3yIS+HmrP2Pjr7MMr3IykXzN7F3LHCGfMtco"
    "BglXVBOqLmZpsNnelD1jsmlF2TAG7q907xwhFIMIWRzgyKQL0ycFl06wapiWtl9Y9UBhamSRgcwIwWyrXyEHcw1zobA0NKoo"
    "9oYMiTNYaPzg7YEm3wXSzoAwIV7a93co+h9G/ZnoYXwkVC+eod8vdiMtH5bHbTa0S7NR2ot/vz8l0Vvh9dZKzukCmDTbjsHD"
    "3yCVfuCJnwZpn5FJfATcikGvBW8cAhi+MVUFNKYDqXQJOEshJrGO4wEbUwO1GaVJXqgU18H6tOpAahZoqm/7UPW4OF5jJndV"
    "hhJzjIokZuPOYw765fWv4/tDrUdmiofWLCPD1/8iW+JzGlDT9tV6BjvoRr9e3FBc5zYgjZ0c+jn2k5sWcIl9VPc6/+FlLMND"
    "61HletLWwU6Z+DC7PVJr4qSHFlqAD38OAsnWHXQVt4PgYPOHpWPdcyO+h0JjTaHRRWomx2WVHShguOQnqH9bSdXwT7OP/Aza"
    "y0H7YwH/VPmwfLtCdGzpwf/dbsFgOi+QfiIJFHhLwV22bQNZbRmi0qxzoxKNSurzvkrHRQJeWsVTohzCwT0uP3BIs321J8sl"
    "fa81+KSrfaCkao/VIDzD+N8STqdFtPLUlV5C2A1mlgkQ5QxMV00hSBKKX0Y+isgisX0JISI38J3vAtdaH6g0BPRBHgB3FkNq"
    "Ls5FPbWiwHHP9NBCYNs7AtvAQB0XB3SvukJZpvlOKHWfnAldRhZmvtib3fTQIhzOaMt5HmvNgjKZSWwP3//iNM2/VJ/Osizo"
    "ObqIVNiMh5MUM/widpbGLkcDMUkFdTMtG5M0PlBqQbIW9s7ufHVWI0kAwu5ufndF6nUlhIrg4l3lY+Jfhvr9MS50c3mocS+A"
    "9vxUFHRbSaxc5ox8Rj4+2GVmb0QlaTEaN6pUV5o6uOJz5LB/VkOhCgocS1Qo5FliSMdhrtWgyIK4nFFM20GKd0k1j2wjM9xn"
    "+nTlattEOEzzzaa14/P+qLgTPiGd3fHmnldufXU9vL/NSkmCux7NdbHvBZQLFsxeMRETZSoEEud5Vs1yTpbOQOqFXxYyCoIa"
    "+zZedpOxp4bwncXxZ27z7oea9sd8U7sdTJ0yNIpmaoFQNKIXBntmuq0H1KtfNpFrLGdrbrp4U+WB5k2XNEsMuQE+NfUnzRwC"
    "sa2opwoLo6+5pGN8cvIo9aBbZeLrqa4VFRUO6v8TcYXthpl1imVxe+iRxgr4JLR8zcpaU91efnp6+utCbGKJFm0Xr85epqaH"
    "400qE29qr83lL3BRdFKu9T0iBKf57QGi9oURwuw2RiCLsiTxfEgLiCvTg0/UstaKo8uu7obXcpMcRJFJCyIbrJZ8WTSzUutl"
    "Ww3FB+/V5jOvBvH4OmTWbBkBRuGcGImeEDTfEr2WW0CuvULISEaCFXGJIa5z2tRdg/obrhDjjGDrNjHyCDDcGzsEXxFXzPfy"
    "RQ0lhm9qyDAArbvpVL46X7nPZ5nvDbY0VrOzCxaoCdqBBAvuEb9QqfcCj/MEt2wx+UiMmomT9hX8aG3YNW9stPUTv+eWOagh"
    "49Wxm0x20GR2m1nAdEAEfLAMtLbwH66v4h5BLf7pv7GKBaCHyV3qloCvFJF6g1SgaHhTKCRG/cp3m6ZyLfVTCM5hfCqWt41K"
    "vv0oPy429X3KM88Rg6E6fkYbnHC+/eX/FY13WxRkQper73WFKwQnLNuk0t4B3aWKTF9o/4BZOnfiYEYaghooA+gPaFjG6/Wk"
    "Nuo1YQ6Xm+zkdiKBKlBA9PPydEgdMnLLzgtLt0UF7u5bcY8yZEaSDBaSPt48p4TGQcBJk1cPnU0LxDGAF7pkFuWprjgUeogu"
    "ABgzDDWpmhwXLmYDCAY+b2tROjB8H8T79v/ZeCaa27vV6pgHpXGJ82yW0QM92YXH/+PuOqfVDdSCg2HcJ3G/buYf+fel/Pwh"
    "3j/n5fYFCcE5/3f/1C5irtGaxWrR4pPbIgXFySdUg2Qdu7ztQgDlE6z/mIYcqRYu1+uo25cLmb7SzjCGa3BUp6FE/yAtLpXd"
    "rMWvc4MbgHbdYAT92ngrjRjnyWeU+psLF2TLndy83ifYsu4tteYSURhQrLRymhXNFFfKz9jcualaZ1H+5le0wwGWhZpdsfyK"
    "JRFifRQTBHVTuvfhqvEED8d1uskXRYULRiewi1o7LBWuOwK5KLYFd5+Ok7Db5vf60bv7xBvdy/vwD3e0lRIK4QHHW0YUwHTC"
    "UWOmnDeJXzWtVJAfbUljTFHz+yYFto2myPikZJHDWwjDYi0ydbicY1LE809jxlObYYhsjYI9Jo1WIaSyf6ALuUPPIn8jDBJ2"
    "D3UJperqRIHmSrrFRLEsC6UtsnUFJ/tXcJdbkgrvEPVM2CaLPC4RCiZhiyd0VlL/ozd9Prj56I6+lMx8zWNx5/4f7/i0tt/y"
    "KyWnlvSOarEiKVFtSqsM+snMYYuj/VpO2Xb25CKI+SwmCl7btLtVeV+9WtfiNehE41qyxKiCP3l7DUS009Ps/o9bThKCfcGj"
    "1gKYQEEvf7wpZYa/9m9s4t6i"
)


def weight(thickness: int) -> str:
    return "bold" if thickness >= 2 else "regular"


def _entry(ch: str, thickness: int):
    table = _TABLE[weight(thickness)]
    return table.get(ch) or table["?"]


def metrics(ch: str, thickness: int, size: int):
    """(advance, descent) of one character in whole pixels at a tabulated
    size."""
    return _entry(ch, thickness)[size][:2]


@lru_cache(maxsize=1)
def _blob() -> bytes:
    return zlib.decompress(base64.b64decode("".join(_COVERAGE)))


def block(ch: str, thickness: int, size: int):
    """(x0, y0, alpha uint8 (h, w)) of one character at a tabulated size."""
    x0, y0, w, h, offset = _entry(ch, thickness)[size][2:]
    alpha = np.frombuffer(_blob(), np.uint8, count=w * h, offset=offset).reshape(h, w)
    return x0, y0, alpha
